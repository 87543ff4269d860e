"""repro_torch's LM serving (``serve.engine.LMServeEngine``, ``lm_loop``,
the gateway's ``/v1/generate`` and the serve CLI's ``--engine lm``) against
the JAX package's, on the CPU.

Both engines get the same weights (the JAX ``init`` through
``convert.lm_params_from_numpy``). Greedy decoding turns a logit that
differs in the last bits into another token wherever the top two logits
nearly tie, and every token after it differs too. So a row's tokens are
held equal up to its first differing token, and there the JAX package's
logit for the port's token must lie within ``MARGIN`` of its top logit
(twice ``test_torch_lm``'s logit tolerance at logits of ~0.7, 2 x (0.02 +
0.02 x 0.7), rounded up): a near tie that tolerance can reorder. The test
says what share of the tokens were held equal. The MoE configs are held
by ``test_torch_lm``, sequence by sequence where both packages route
alike; here a flipped route would end a row early without a near tie.
"""
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as j_cfgs
from repro.gateway import GatewayClient as JaxClient
from repro.nn import transformer as j_tfm
from repro.serve import engine as j_engine
from repro.serve import scheduler as j_sched
from repro_torch import convert
from repro_torch.gateway import EnginePump, GatewayClient, GatewayServer
from repro_torch.serve import engine as t_engine
from repro_torch.serve.scheduler import SchedulerConfig

ROOT = Path(__file__).resolve().parents[1]
MARGIN = 0.07
ARCH = "minitron-8b"


def jax_weights(arch: str = ARCH, seed: int = 0):
    cfg = j_cfgs.reduced(j_cfgs.get_arch(arch))
    jp = j_tfm.init(jax.random.PRNGKey(seed), cfg)
    return cfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def jax_logits(cfg, jp, prompts: np.ndarray, tokens: np.ndarray) -> np.ndarray:
    """(w, decode, vocab) logits of the JAX package along its own greedy
    tokens (prefill, then decode steps fed those tokens)."""
    logits, cache = j_tfm.prefill(jp, cfg, jnp.asarray(prompts),
                                  max_len=prompts.shape[1] + tokens.shape[1])
    out = []
    for t in range(tokens.shape[1]):
        out.append(np.asarray(logits))
        if t + 1 < tokens.shape[1]:
            logits, cache = j_tfm.decode_step(jp, cfg, cache, jnp.asarray(tokens[:, t]))
    return np.stack(out, axis=1)


def assert_greedy_agrees(got: np.ndarray, want: np.ndarray, logits: np.ndarray) -> float:
    """Each row equal up to its first differing token, where the JAX
    package's logit for the port's token must lie within MARGIN of its
    top logit (a near tie that the logit tolerance can reorder); returns
    the share of tokens held equal."""
    equal = 0
    for r in range(want.shape[0]):
        diff = np.flatnonzero(got[r] != want[r])
        if diff.size:
            t = diff[0]
            gap = logits[r, t, want[r, t]] - logits[r, t, got[r, t]]
            assert 0 <= gap <= MARGIN, (r, t, gap, got[r], want[r])
        equal += diff[0] if diff.size else want.shape[1]
    return equal / want.size


def prompts_for(vocab: int, n: int, prefill: int, seed: int) -> list:
    """Prompts of mixed lengths: short ones (left-padded), ones longer than
    ``prefill`` (clipped to their last tokens) and ids past the vocabulary
    (clipped to vocab - 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = [3, prefill, prefill + 5, 1][i % 4]
        out.append(rng.integers(0, vocab + 40, length).astype(np.int64))
    return out


@pytest.mark.parametrize("arch", ["minitron-8b", "starcoder2-7b"])
def test_lm_engine_matches_jax_engine(arch):
    """forward on 8 prompts (two batches of 4) through both engines on the
    same weights: tokens equal as the module says, tokens_generated alike.
    Share of tokens held equal: printed, and at least half."""
    cfg, jp, np_params = jax_weights(arch)
    sched = dict(max_batch=4, max_queue=16)
    je = j_engine.LMServeEngine(arch=arch, smoke=True, prefill=16, decode=8, params=jp,
                                sched_config=j_sched.SchedulerConfig(**sched))
    te = t_engine.LMServeEngine(arch=arch, smoke=True, prefill=16, decode=8,
                                params=convert.lm_params_from_numpy(np_params, "cpu"),
                                sched_config=SchedulerConfig(**sched), device="cpu")
    assert te.cfg == t_engine._lm_config(arch, True) and te.params["embed"].device.type == "cpu"
    prompts = prompts_for(cfg.vocab, 8, 16, seed=1)
    shares = []
    for i in (0, 4):
        payloads = [{"tokens": p} for p in prompts[i:i + 4]]
        got = te.forward(payloads)
        want = je.forward(payloads)
        assert got.dtype == np.int32 and got.shape == want.shape == (4, 8)
        padded = np.zeros((4, 16), np.int32)
        for r, p in enumerate(prompts[i:i + 4]):
            t = np.clip(p[-16:], 0, cfg.vocab - 1)
            padded[r, 16 - t.size:] = t
        shares.append(assert_greedy_agrees(got, want, jax_logits(cfg, jp, padded, want)))
    print(f"{arch}: share of tokens held equal {np.mean(shares):.3f}")
    assert np.mean(shares) >= 0.5
    assert te.metrics.counters["tokens_generated"] == je.metrics.counters["tokens_generated"] == 64


def test_lm_engine_batches_pad_and_clip_like_jax():
    """A partial batch is padded with zero rows after the real ones, a
    prompt is cut to its last ``prefill`` ids and clipped to the
    vocabulary; warmup touches no counter; step() serves queued requests."""
    cfg, _, np_params = jax_weights()
    params = convert.lm_params_from_numpy(np_params, "cpu")
    te = t_engine.LMServeEngine(prefill=8, decode=4, params=params, device="cpu",
                                sched_config=SchedulerConfig(max_batch=3, max_queue=8))
    te.warmup()
    assert te.metrics.counters.get("tokens_generated", 0) == 0
    long = np.arange(20) + cfg.vocab - 10        # last 8 ids, some past the vocab
    clipped = np.clip(long[-8:], 0, cfg.vocab - 1)
    a = te.forward([{"tokens": long}])
    b = te.forward([{"tokens": clipped}, {"tokens": [5, 6]}])
    assert np.array_equal(a[0], b[0]) and a.shape == (1, 4) and b.shape == (2, 4)
    reqs = [te.submit({"tokens": np.array([1, 2, 3])}) for _ in range(4)]
    te.run_until_idle()
    assert all(r.result.shape == (4,) for r in reqs)
    assert all(np.array_equal(r.result, reqs[0].result) for r in reqs)
    assert te.metrics.counters["tokens_generated"] == 4 * (1 + 2 + 4)


def test_lm_loop_partial_batch_counts_served_tokens(capsys):
    """tests/test_serve.py's partial-batch test on the port: requests %
    batch != 0, and the loop serves exactly requests * decode tokens."""
    stats = t_engine.lm_loop(arch="minitron-8b", smoke=True, requests=5, batch=4,
                             prefill=8, decode=4, device="cpu")
    assert stats["requests"] == 5
    assert stats["tokens"] == 5 * 4
    assert stats["tok_s"] > 0 and stats["p99_ms"] >= stats["p50_ms"] > 0
    out = capsys.readouterr().out
    assert re.match(r"\[serve\] 5 requests, 20 tokens in [\d.]+s \([\d.]+ tok/s\); "
                    r"batch latency p50=\d+ms p99=\d+ms", out), out


def test_server_generate_roundtrip_deterministic():
    """tests/test_gateway.py's test over the port's LMServeEngine."""
    eng = t_engine.LMServeEngine(arch="minitron-8b", smoke=True, device="cpu",
                                 sched_config=SchedulerConfig(max_batch=2, max_queue=8),
                                 prefill=8, decode=4)
    eng.warmup()
    prompt = [1, 2, 3, 4, 5]
    with GatewayServer({"generate": EnginePump(eng, "generate")}) as server:
        client = GatewayClient(server.url, timeout_s=60.0)
        out1 = client.generate(prompt, timeout_s=60.0)
        out2 = client.generate(prompt, timeout_s=60.0)
    assert len(out1) == 4 and out1 == out2          # greedy => deterministic
    assert eng.metrics.counters["tokens_generated"] == 8
    ref = eng.forward([{"tokens": np.asarray(prompt)}])[0]
    assert out1 == ref.tolist()


def test_jax_client_generates_through_port_server():
    """The JAX package's client against the port's gateway on the JAX
    package's weights: the wire gives the port engine's tokens, and they
    agree with the JAX engine's as the module says."""
    cfg, jp, np_params = jax_weights()
    eng = t_engine.LMServeEngine(prefill=8, decode=6, device="cpu",
                                 params=convert.lm_params_from_numpy(np_params, "cpu"),
                                 sched_config=SchedulerConfig(max_batch=2, max_queue=8))
    je = j_engine.LMServeEngine(prefill=8, decode=6, params=jp,
                                sched_config=j_sched.SchedulerConfig(max_batch=2, max_queue=8))
    prompt = [7, 1, 300, 42]
    with GatewayServer({"generate": EnginePump(eng, "generate")}) as server:
        got = JaxClient(server.url, timeout_s=60.0).generate(prompt, timeout_s=60.0)
    assert got == eng.forward([{"tokens": np.asarray(prompt)}])[0].tolist()
    want = je.forward([{"tokens": np.asarray(prompt)}])
    padded = np.zeros((2, 8), np.int32)
    padded[0, 4:] = prompt
    logits = jax_logits(cfg, jp, padded, np.concatenate([want, np.zeros_like(want)]))
    assert_greedy_agrees(np.asarray([got]), want, logits[:1])


def run_cli(args, timeout=120.0):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_serve_cli_lm_loop_subprocess():
    """``--engine lm --device cpu``: the reduced starcoder2-7b at the CLI's
    defaults (16 requests, batches of 8, prefill 64, decode 32)."""
    proc = run_cli(["--engine", "lm", "--device", "cpu"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"\[serve\] 16 requests, 512 tokens in ", proc.stdout), proc.stdout


def test_serve_cli_lm_gateway_subprocess():
    """``--engine lm --gateway --device cpu`` serves /v1/generate, drains on
    SIGINT and exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--engine", "lm",
         "--gateway", "127.0.0.1:0", "--device", "cpu", "--prefill", "16", "--decode", "4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url, lines = None, []
        deadline = time.monotonic() + 120.0
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"\[gateway\] .* on (http://\S+) ", line)
            url = m.group(1) if m else None
        assert url, "".join(lines)
        assert "/v1/generate" in lines[-1] and "; cpu)" in lines[-1]
        out = GatewayClient(url, timeout_s=30.0).generate([1, 2, 3], timeout_s=30.0)
        assert len(out) == 4 and all(isinstance(t, int) for t in out)
        proc.send_signal(signal.SIGINT)
        rest, _ = proc.communicate(timeout=60.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10.0)
    assert proc.returncode == 0, "".join(lines) + rest
    assert "[gateway] stopped: completed=1" in rest
