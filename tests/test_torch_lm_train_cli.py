"""The port's LM train CLI (``python -m repro_torch.launch.train``) and the
LM example twins (``examples/train_lm_torch.py``,
``examples/serve_lm_torch.py``) on the CPU, in subprocesses."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.train import checkpoint as ckpt_mod

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the train CLI and the example twins, in subprocesses
# ---------------------------------------------------------------------------
def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable] + args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_train_cli_smoke_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --smoke`` with checkpoints and
    an injected failure: the reference's log lines, the loss falls, the
    last checkpoint is the last step."""
    out = _run(["-m", "repro_torch.launch.train", "--smoke", "--steps", "8", "--batch", "4",
                "--seq", "64", "--fail-at", "3", "5", "--ckpt", str(tmp_path), "--device",
                "cpu"])
    lines = out.splitlines()
    assert sum(line.startswith("[train] step") for line in lines) >= 8
    done = [line for line in lines if line.startswith("[train] done: first loss ")]
    assert len(done) == 1
    first, last = (float(x) for x in done[0].removeprefix("[train] done: first loss ").split(
        " -> last "))
    assert last < first
    assert ckpt_mod.latest_step(str(tmp_path)) == 8


@pytest.mark.parametrize("example", ["train", "serve", "serve --gateway"])
def test_example_twins_run_on_the_cpu(example):
    """examples/train_lm_torch.py (a few steps, a failure at step 3, the
    loss falling) and examples/serve_lm_torch.py, locally and behind the
    gateway, at ``--device cpu``."""
    name, *rest = example.split()
    # the example logs every 20 steps: 20 steps log the first and the last
    args = {"train": ["--steps", "20", "--fail-at", "3"], "serve": ["--requests", "4"]}[name]
    out = _run([str(ROOT / "examples" / f"{name}_lm_torch.py"), "--device", "cpu"] + args
               + rest)
    if name == "train":
        assert "over 20 steps (1 restart)" in out
    elif rest:
        assert out.count("-> continuation=") == 3 and "served 24 tokens over HTTP" in out
    else:
        assert "[serve] 4 requests, 128 tokens" in out
