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
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "graph_suite_torch.py", ROOT / "examples" / "train_lm_torch.py",
    ROOT / "examples" / "serve_lm_torch.py",
    ROOT / "scripts" / "torch_profile_pagerank.py", ROOT / "scripts" / "k1_d1_layouts.py",
    ROOT / "scripts" / "torch_profile_graph_suite.py", ROOT / "scripts" / "torch_profile_gnn_serve.py",
    ROOT / "scripts" / "k1_d1_layouts.cu", ROOT / "scripts" / "k2_k3_times.py",
    ROOT / "scripts" / "k3_layouts.py", ROOT / "scripts" / "k3_layouts.cu",
    ROOT / "scripts" / "index_add_pad_runs.py", ROOT / "scripts" / "grasp_step_noise.py"],
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


def test_graph_suite_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(ROOT / "examples"))
    import graph_suite_torch

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graph_suite_torch.main()


def test_serving_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import base
    from repro_torch.launch import serve as serve_cli
    from repro_torch.nn import recsys
    from repro_torch.serve import cache, engine, scheduler

    cfg = base.reduced(base.get_arch("mind"))
    table = np.zeros((64, 4), np.float32)
    cc = cache.CacheConfig(budget_bytes=16 * 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recsys.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cache.EmbeddingCache(table, cc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.run_recsys_stream(cfg, cc, scheduler.SchedulerConfig(), engine.StreamConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--engine", "recsys", "--requests", "2"])
    params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.RecsysServeEngine(params, cfg, cc, scheduler.SchedulerConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.mind_params_from_numpy({k: v for k, v in params.items()})
    assert cache.EmbeddingCache(table, cc, device="cpu").device.type == "cpu"

    from repro_torch.graph import generate
    from repro_torch.nn import gnn

    gin = base.reduced(base.get_arch("gin-tu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gnn.init(torch.Generator().manual_seed(0), gin, 4)
    gparams = gnn.init(torch.Generator().manual_seed(0), gin, 4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.gnn_params_from_numpy(gnn.tree_map(lambda t: t.numpy(), gparams))
    g = generate.rmat(6, 4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.GNNServeEngine(gparams, gin, g, table, cc, scheduler.SchedulerConfig())
    eng = engine.GNNServeEngine(gparams, gin, g, table, cc, scheduler.SchedulerConfig(),
                                device="cpu")
    assert eng.cache.device.type == "cpu"


def test_serve_gateway_without_device_raises_without_cuda(monkeypatch):
    """The serve CLI's --gateway builds its engine on --device (default
    cuda): without a card it raises devices.resolve's error before any
    server starts, for either engine, unless --device cpu."""
    import threading

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import serve as serve_cli

    threads = threading.active_count()
    for engine in ("recsys", "lm"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_cli.main(["--engine", engine, "--gateway", "127.0.0.1:0"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_cli.main(["--engine", engine, "--gateway", "127.0.0.1:0", "--device", "cuda:0"])
    assert threading.active_count() == threads       # no server was started


def test_lm_entry_points_without_device_raise_without_cuda(monkeypatch):
    """The LM's entry points default to the card and raise without one;
    each runs on the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import base
    from repro_torch.launch import serve as serve_cli
    from repro_torch.nn import transformer
    from repro_torch.serve import engine

    cfg = base.reduced(base.get_arch("minitron-8b"))
    params = transformer.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    as_numpy = {"embed": params["embed"].numpy(), "ln_f": {"g": np.ones(4, np.float32)}}
    for build in (lambda **kw: transformer.init(torch.Generator().manual_seed(0), cfg, **kw),
                  lambda **kw: transformer.init_cache(cfg, 1, 4, **kw),
                  lambda **kw: engine.LMServeEngine(prefill=4, decode=2, **kw),
                  lambda **kw: engine.LMServeEngine(prefill=4, decode=2, params=params, **kw),
                  lambda **kw: engine.lm_loop(requests=1, batch=1, prefill=4, decode=2, **kw),
                  lambda **kw: convert.lm_params_from_numpy(as_numpy, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        build(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--engine", "lm", "--requests", "1"])
    assert transformer.prefill(params, cfg, torch.zeros((1, 4), dtype=torch.int32))[0].device.type \
        == "cpu"


def test_lm_training_entry_points_without_device_raise_without_cuda(monkeypatch, tmp_path):
    """The train CLI, ``lm_train_step`` and the LM example twins default to
    the card and raise without one, before any step or checkpoint; each
    runs on the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(ROOT / "examples"))
    import serve_lm_torch
    import train_lm_torch

    from repro_torch.configs import base
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_cli

    cfg = base.reduced(base.get_arch("minitron-8b"))
    shape = base.LMShape("t", "train", 64, 2)
    ckpt = tmp_path / "ckpt"
    for run in (lambda: train_cli.main(["--smoke", "--steps", "1", "--ckpt", str(ckpt)]),
                lambda: train_cli.main(["--smoke", "--steps", "1", "--device", "cuda:0"]),
                lambda: steps.lm_train_step(cfg, shape),
                lambda: train_lm_torch.main(["--steps", "1"]),
                lambda: serve_lm_torch.main(["--requests", "1"]),
                lambda: serve_lm_torch.main(["--gateway"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    assert not ckpt.exists()
    steps.lm_train_step(cfg, shape, device="cpu")
    state = train_cli.main(["--smoke", "--steps", "1", "--batch", "2", "--seq", "64",
                            "--device", "cpu"])
    assert state["params"]["embed"].device.type == "cpu" and int(state["opt"]["step"]) == 1


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


def test_embedding_bag_wrappers_refuse_meta_tensors():
    from repro_torch.kernels.embedding_bag import embedding_bag, ops

    hot = torch.empty((16, 4), device="meta")
    ids = torch.empty((8, 5), dtype=torch.int32, device="meta")
    mask = torch.empty((8, 5), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="no embedding-bag kernel"):
        embedding_bag.hot_bag_hot_part(hot, ids, mask)
    with pytest.raises(RuntimeError, match="no embedding-bag kernel"):
        ops.hot_bag(hot, ids, mask, hot_size=8)
    with pytest.raises(ValueError):  # ids on another device than the table
        embedding_bag.hot_bag_hot_part(torch.zeros((16, 4)), ids, mask)


def test_training_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import base
    from repro_torch.launch import steps
    from repro_torch.train import optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gin, mind = base.reduced(base.get_arch("gin-tu")), base.reduced(base.get_arch("mind"))
    molecule = base.GNN_SHAPES["molecule"]
    state = {"m": {"w": np.zeros((2, 3), np.float32)}, "step": np.zeros((), np.int32)}
    args = (lambda p, b: (p["w"] * b["x"]).sum(), lambda: {"w": torch.ones(3)},
            optimizer.OptConfig(name="sgd"), TrainerConfig(num_steps=2))
    for build in (lambda **kw: Trainer(*args, **kw),
                  lambda **kw: steps.gnn_train_step(gin, molecule, **kw),
                  lambda **kw: steps.recsys_train_step(mind, **kw),
                  lambda **kw: convert.opt_state_from_numpy(state, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        build(device="cpu")
    trainer = Trainer(*args, device="cpu")
    out = trainer.fit(lambda step: {"x": np.ones(3, np.float32)})
    assert out["params"]["w"].device.type == "cpu" and int(out["opt"]["step"]) == 2
    assert convert.opt_state_from_numpy(state, "cpu")["step"].dtype == torch.int32
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.gnn_train_step(base.get_arch("gin-tu"), base.GNN_SHAPES["ogb_products"])


def test_grasp_train_step_without_process_group_raises(monkeypatch):
    """The GRASP branch of gnn_train_step (gin + grasp on ogb_products), the
    GRASP step builder and the compressed all-reduce raise without an
    initialised process group: none starts one, none drifts to the CPU or
    to an unpartitioned step."""
    import torch.distributed as dist

    from repro_torch.configs import base
    from repro_torch.dist import collectives
    from repro_torch.launch import steps
    from repro_torch.train import compression, optimizer

    assert not dist.is_initialized()
    gin, products = base.get_arch("gin-tu"), base.GNN_SHAPES["ogb_products"]
    spec = collectives.partition_spec_for(products.n_nodes, products.n_edges, 1)
    update = optimizer.make(optimizer.OptConfig())[1]
    for build in (lambda: steps.gnn_train_step(gin, products, device="cpu"),
                  lambda: collectives.make_grasp_gin_step(spec, gin, 100, 47, None, update,
                                                          device="cpu"),
                  lambda: compression.compressed_psum({"w": torch.ones(2)}, {"w": torch.zeros(2)})):
        with pytest.raises(RuntimeError, match="no torch.distributed process group"):
            build()
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.gnn_train_step(gin, products)
