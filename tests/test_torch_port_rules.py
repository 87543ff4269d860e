"""Rules of the port: repro_torch and chip_smoke.py import neither jax nor
repro; entry points never drift to the CPU; kernel wrappers refuse devices
they have no kernel for."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_importing_the_port_leaves_jax_and_repro_out():
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(MODULES) >= 20


FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    text = path.read_text()
    assert not FORBIDDEN.findall(text), FORBIDDEN.findall(text)
    assert "import_module(\"repro" not in text and "__import__(\"jax" not in text


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import devices
    from repro_torch.graph import generate

    g = generate.rmat(6, 4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g.device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        devices.resolve()
    assert g.device("cpu").indices.device.type == "cpu"


def test_quickstart_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(ROOT / "examples"))
    import quickstart_torch

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart_torch.main()


def test_kernel_wrappers_refuse_meta_tensors():
    from repro_torch.kernels.hot_gather import hot_gather, ops

    hot = torch.empty((16, 4), device="meta")
    idx = torch.empty(32, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no hot-gather kernel"):
        hot_gather.hot_gather_hot_part(hot, idx)
    with pytest.raises(RuntimeError, match="no hot-gather kernel"):
        hot_gather.hot_gather_segment_sum(hot, idx, idx, 4, tile_e=32, seg_per_tile=4)
    with pytest.raises(RuntimeError, match="no hot-gather kernel"):
        ops.hot_gather(hot, idx)
    with pytest.raises(ValueError):  # index on another device than the table
        hot_gather.hot_gather_hot_part(torch.zeros((16, 4)), idx)
