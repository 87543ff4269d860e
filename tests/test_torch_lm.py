"""repro_torch's transformer LM (``nn.layers``, ``nn.transformer``), its
configs and batches against the JAX package's, on the CPU.

Parameters come from the JAX ``init`` and reach the port through
``convert.lm_params_from_numpy``; every other input is drawn from a numpy
seed. Tolerances (``|port - jax| <= atol + rtol * |jax|``):

- norms, RoPE and the activations in bfloat16: equal bits, but for
  ``gelu``, whose tanh rounds its last bit the other way in 0.25% of
  bfloat16 values (so x * cdf moves by at most 2^-7 |x|), and RoPE at
  large offsets (one bfloat16 ulp, ``BF16_ULP``). In float32, 1e-6.
- one bfloat16 product (``dense``, attention, FFN, the MoE layer on equal
  inputs): torch's CPU product and XLA's round the other way in
  0.005-0.025% of elements, so ``BF16_TOL`` (rtol = atol = 1e-2) bounds one
  layer; measured: attention at 2,048 queries 9.8e-4, the FFN and MoE
  layers 4.9e-4.
- a whole model's logits (``MODEL_TOL``, rtol = atol = 2e-2): those
  flipped roundings carry through the layers; the five reduced configs
  reach 9.0e-3 on logits of up to 0.73 (four seeds each). The KV cache
  (``CACHE_TOL``) is bfloat16 and its later layers see the carried
  differences whole: up to 3.1e-2 on entries up to ~3, so it is held to
  the JAX package's own tolerance for these bfloat16 paths (rtol 0.06,
  atol 5e-2, ``tests/test_nn.py``), which is the ceiling for both.

A MoE model is not continuous: where a flipped rounding moves a token's
router probabilities across a tie, the token goes to another expert (and
ranks the picks after it differently), and its sequence's logits move by
0.1-0.3. The model test records both packages' expert choices at every MoE
call and holds to ``MODEL_TOL`` every sequence that both route alike; it
says how many that is, and requires at least half.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_cfgs
from repro.data import pipeline as j_pipe
from repro.nn import layers as j_layers
from repro.nn import transformer as j_tfm
from repro_torch import convert
from repro_torch.configs import base as t_cfgs
from repro_torch.data import pipeline as t_pipe
from repro_torch.nn import layers as t_layers
from repro_torch.nn import transformer as t_tfm
from repro_torch.train.tree import tree_leaves

LM_ARCHS = ["minitron-8b", "starcoder2-7b", "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b",
            "nemotron-4-340b"]
BF16_ULP = dict(rtol=2.0 ** -7, atol=0.0)
F32_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
MODEL_TOL = dict(rtol=2e-2, atol=2e-2)
CACHE_TOL = dict(rtol=0.06, atol=5e-2)
BF = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def both(a: np.ndarray, dtype: str = "bf16"):
    """``a`` as a JAX array and a tensor of the same dtype and values."""
    jd, td = BF[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol) -> None:
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def jax_params(cfg, seed: int = 0):
    """The JAX package's parameters and the port's copy of them."""
    jp = j_tfm.init(jax.random.PRNGKey(seed), cfg)
    return jp, convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def cfg_pair(arch):
    return j_cfgs.reduced(j_cfgs.get_arch(arch)), t_cfgs.reduced(t_cfgs.get_arch(arch))


# ---------------------------------------------------------------------------
# configs and batches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_match_jax(arch):
    for j, t in [(j_cfgs.get_arch(arch), t_cfgs.get_arch(arch)), cfg_pair(arch)]:
        assert type(t).__name__ == "LMConfig"
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.head_dim, t.family) == (j.head_dim, j.family) == (j.d_model // j.n_heads, "lm")
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert t_cfgs.get_arch("minitron-8b").param_count() == 7_734_558_720


def test_lm_shapes_and_registry_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in t_cfgs.LM_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_cfgs.LM_SHAPES.items()}
    assert sorted(t_cfgs.SHAPES) == sorted(j_cfgs.SHAPES)
    assert sorted(t_cfgs.all_archs()) == sorted(j_cfgs.all_archs())


@pytest.mark.parametrize("batch,seq", [(1, 1), (4, 33), (16, 128)])
def test_lm_batch_matches_jax(batch, seq):
    jcfg, tcfg = cfg_pair("starcoder2-7b")
    j = j_pipe.lm_batch(np.random.default_rng(batch), jcfg, batch, seq)
    t = t_pipe.lm_batch(np.random.default_rng(batch), tcfg, batch, seq)
    assert sorted(t) == sorted(j) == ["labels", "tokens"]
    for k in j:
        assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])
    shape = j_cfgs.LMShape("tiny", "train", seq, batch)
    jfn = j_pipe.make_batch_fn("lm", jcfg, shape, seed=3)
    tfn = t_pipe.make_batch_fn("lm", tcfg, t_cfgs.LMShape("tiny", "train", seq, batch), seed=3)
    for step in (0, 5):
        assert all(np.array_equal(tfn(step)[k], jfn(step)[k]) for k in ("tokens", "labels"))


# ---------------------------------------------------------------------------
# norms, position, activations, FFN
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(0)
    jx, tx = both(rng.standard_normal((3, 5, 64)).astype(np.float32) * 3, dtype)
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    tol = dict(rtol=0, atol=0) if dtype == "bf16" else F32_TOL
    jr = j_layers.rmsnorm({"g": jnp.asarray(g)}, jx)
    tr = t_layers.rmsnorm({"g": torch.from_numpy(g)}, tx)
    assert tr.dtype == tx.dtype
    close(tr, jr, tol)
    jn = j_layers.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jx)
    tn = t_layers.layernorm({"g": torch.from_numpy(g), "b": torch.from_numpy(b)}, tx)
    close(tn, jn, tol)
    assert {k: v.shape for k, v in t_layers.rmsnorm_init(64, (3,)).items()} == {"g": (3, 64)}


@pytest.mark.parametrize("offset", [0, 7, 1000, 32767])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_rope_matches_jax(offset, dtype):
    """Interleaved pairs, float32 angles, at offsets up to the 32k prefill."""
    rng = np.random.default_rng(offset)
    jx, tx = both(rng.standard_normal((2, 9, 4, 16)).astype(np.float32), dtype)
    pos = (offset + np.arange(9))[None].repeat(2, 0).astype(np.int32)
    j = j_layers.rope(jx, jnp.asarray(pos), 10000.0)
    t = t_layers.rope(tx, torch.from_numpy(pos), 10000.0)
    assert t.dtype == tx.dtype
    close(t, j, BF16_ULP if dtype == "bf16" else F32_TOL)
    # the pairs are (0, 1), (2, 3), ...: position 0 is the identity
    z = t_layers.rope(tx, torch.zeros((2, 9), dtype=torch.int32))
    assert torch.equal(z, tx)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu2", "relu"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_activations_match_jax(act, dtype):
    x = np.random.default_rng(1).standard_normal(50_000).astype(np.float32) * 3
    jx, tx = both(x, dtype)
    j, t = f32(j_layers.ACTS[act](jx)), f32(t_layers.ACTS[act](tx))
    if dtype == "f32":
        np.testing.assert_allclose(t, j, **F32_TOL)
    elif act == "gelu":
        # a cdf one bfloat16 ulp apart (at most 2^-8 below 1) moves x * cdf
        # by at most 2^-8 |x| before the product's own rounding
        assert np.all(np.abs(t - j) <= 2.0 ** -7 * np.abs(f32(jx)))
        assert np.mean(t != j) < 0.005
    else:
        assert np.array_equal(t, j)


@pytest.mark.parametrize("gated,act", [(False, "relu2"), (False, "gelu"), (True, "silu")])
def test_ffn_matches_jax(gated, act):
    jp = j_layers.ffn_init(jax.random.PRNGKey(2), 64, 128, gated)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jx, tx = both(np.random.default_rng(2).standard_normal((3, 7, 64)).astype(np.float32))
    j, t = j_layers.ffn(jp, jx, act=act), t_layers.ffn(tp, tx, act=act)
    assert t.dtype == torch.bfloat16 and t.shape == (3, 7, 64)
    close(t, j, BF16_TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def qkv(b, sq, sk, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (both(rng.standard_normal((b, sq, h, hd)).astype(np.float32)),
            both(rng.standard_normal((b, sk, kv, hd)).astype(np.float32)),
            both(rng.standard_normal((b, sk, kv, hd)).astype(np.float32)))


@pytest.mark.parametrize("kv_len", [1, 13, 40])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])
def test_attention_decode_matches_jax(kv_len, h, kv):
    """One query against a 40-position cache, the valid prefix masked."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(3, 1, 40, h, kv, 16, kv_len)
    j = j_layers.attention(jq, jk, jv, causal=False, kv_len=jnp.int32(kv_len))
    t = t_layers.attention(tq, tk, tv, causal=False, kv_len=kv_len)
    assert t.dtype == torch.bfloat16 and t.shape == (3, 1, h, 16)
    close(t, j, BF16_TOL)
    # causal decode at q_offset: the keys past it are masked
    j = j_layers.attention(jq, jk, jv, causal=True, q_offset=kv_len - 1)
    t = t_layers.attention(tq, tk, tv, causal=True, q_offset=kv_len - 1)
    close(t, j, BF16_TOL)


@pytest.mark.parametrize("sq,q_chunk,kv_chunk,h,kv", [
    (12, 512, 1024, 4, 2),       # one chunk each (serving prefill)
    (2048, 512, 1024, 4, 2),     # 4 query blocks x 2 KV chunks, GQA
    (384, 100, 64, 4, 1),        # sizes the chunks do not divide: 3 x 128, 6 x 64
    (256, 64, 32, 8, 8),         # 4 x 8, no GQA
])
def test_attention_prefill_matches_jax(sq, q_chunk, kv_chunk, h, kv):
    (jq, tq), (jk, tk), (jv, tv) = qkv(1, sq, sq, h, kv, 16, sq)
    j = j_layers.attention(jq, jk, jv, q_chunk=q_chunk, kv_chunk=kv_chunk)
    t = t_layers.attention(tq, tk, tv, q_chunk=q_chunk, kv_chunk=kv_chunk)
    assert t.dtype == torch.bfloat16 and t.shape == (1, sq, h, 16)
    close(t, j, BF16_TOL)
    # the same attention in one chunk: chunking moves only roundings
    one = t_layers.attention(tq, tk, tv, q_chunk=sq, kv_chunk=sq)
    close(t, one, BF16_TOL)


def test_attention_prefill_with_kv_len_and_offset_matches_jax():
    """Queries at an offset into a longer cache, its tail masked by kv_len."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(2, 64, 256, 4, 2, 16, 9)
    kw = dict(q_offset=150, q_chunk=32, kv_chunk=64)
    j = j_layers.attention(jq, jk, jv, kv_len=jnp.int32(200), **kw)
    t = t_layers.attention(tq, tk, tv, kv_len=200, **kw)
    close(t, j, BF16_TOL)


def test_attention_lengths_the_chunks_do_not_tile_raise():
    """sk = 2,501 is 2 KV chunks of 1,250 and one left over: the JAX
    package's reshape fails, and the port raises rather than pad."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(1, 2501, 2501, 2, 1, 8, 0)
    with pytest.raises(TypeError):
        j_layers.attention(jq, jk, jv)
    with pytest.raises(ValueError, match="not 2 chunks of 1250"):
        t_layers.attention(tq, tk, tv)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_routing(probs: np.ndarray, top_k: int, cap: int):
    """(expert ids, kept) of each (token, k) pick, by the JAX package's rule."""
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k].reshape(-1)
    ranks = np.array([np.sum(idx[:i] == e) for i, e in enumerate(idx)])
    return idx, ranks < cap


@pytest.mark.parametrize("top_k,capacity_factor,gated", [
    (1, 1.25, True), (2, 1.25, True), (2, 0.5, False), (2, 2.0, True)])
def test_moe_matches_jax(top_k, capacity_factor, gated):
    """Top-1 and top-2 over 4 experts, 48 tokens; at capacity factor 0.5
    (12 slots an expert for 96 picks) a quarter of the picks or more are
    dropped. Output within BF16_TOL, aux loss within 1e-6."""
    t, e = 48, 4
    jp = j_layers.moe_init(jax.random.PRNGKey(3), 64, 128, e, gated)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jx, tx = both(np.random.default_rng(3).standard_normal((t, 64)).astype(np.float32))
    jo, ja = j_layers.moe(jp, jx, top_k, capacity_factor=capacity_factor)
    to, ta = t_layers.moe(tp, tx, top_k, capacity_factor=capacity_factor)
    assert to.dtype == torch.bfloat16 and to.shape == (t, 64)
    close(to, jo, BF16_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    probs = f32(torch.softmax(t_layers.dense(tp["router"], tx, torch.float32), -1))
    cap = int(np.ceil(t * top_k / e * capacity_factor))
    _, kept = moe_routing(probs, top_k, cap)
    if capacity_factor < 1:
        assert kept.mean() <= 0.75
    # a token all of whose picks were dropped gets zeros in both packages
    dropped = ~kept.reshape(t, top_k).any(axis=1)
    assert np.all(f32(to)[dropped] == 0) and np.all(f32(jo)[dropped] == 0)


def test_moe_ranks_follow_token_order_with_ties():
    """Equal router probabilities: the port's top-k picks lax.top_k's
    experts (the lower index first), and capacity keeps the earliest picks."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.3, 0.2, 0.2], [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = t_layers.top_k_experts(torch.from_numpy(probs), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
    # a router that scores every expert alike: 8 tokens, top-1, cap 3 an expert
    jp = j_layers.moe_init(jax.random.PRNGKey(4), 16, 32, 4, True)
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jx, tx = both(np.random.default_rng(4).standard_normal((8, 16)).astype(np.float32))
    jo, _ = j_layers.moe(jp, jx, 1, capacity_factor=1.5)
    to, _ = t_layers.moe(tp, tx, 1, capacity_factor=1.5)
    close(to, jo, BF16_TOL)
    kept = np.any(f32(to) != 0, axis=1)
    assert kept.tolist() == [True] * 3 + [False] * 5   # all to expert 0, 3 slots


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_matches_jax_layout(arch):
    """The port's init: the JAX package's tree, shapes, dtypes and scales
    (each leaf's standard deviation within 10% of the JAX package's)."""
    jcfg, tcfg = cfg_pair(arch)
    jp = j_tfm.init(jax.random.PRNGKey(0), jcfg)
    tp = t_tfm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = tree_leaves(tp)
    assert len(tl) == len(jl)
    for (path, j), t in zip(jl, tl):
        assert tuple(t.shape) == j.shape and str(t.dtype).endswith(str(j.dtype)), path
        js, ts = float(jnp.std(j)), float(t.std())
        assert abs(ts - js) <= 0.1 * js + 1e-7, (path, ts, js)
    assert tp["layers"]["attn"]["wq"]["w"].shape[0] == tcfg.n_layers


class Routing:
    """Each package's expert choices at every MoE call, in call order: the
    JAX package's through ``jax.debug.callback`` (its layers run inside a
    scan), the port's from the same router arithmetic."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        j_moe, t_moe = j_layers.moe, t_layers.moe

        def j_wrap(params, x, top_k, **kw):
            probs = jax.nn.softmax(j_layers.dense(params["router"], x, jnp.float32), axis=-1)
            jax.debug.callback(lambda i: self.jax.append(np.asarray(i)),
                               jax.lax.top_k(probs, top_k)[1], ordered=True)
            return j_moe(params, x, top_k, **kw)

        def t_wrap(params, x, top_k, **kw):
            probs = torch.softmax(t_layers.dense(params["router"], x, torch.float32), -1)
            self.port.append(t_layers.top_k_experts(probs, top_k)[1].numpy())
            return t_moe(params, x, top_k, **kw)

        monkeypatch.setattr(j_layers, "moe", j_wrap)
        monkeypatch.setattr(t_layers, "moe", t_wrap)

    def agree(self, batch: int) -> np.ndarray:
        """Per sequence: every call since the last ``agree`` routed its
        tokens alike in both packages (and so ranked them alike: the
        ranks follow the expert ids in token order). A token routed
        differently puts the sequences of every token after it at risk
        through the capacity ranks, so those are counted as differing
        too."""
        jax.effects_barrier()
        assert len(self.jax) == len(self.port)
        ok = np.ones(batch, bool)
        for j, t in zip(self.jax, self.port):
            diff = np.flatnonzero((j != t).any(axis=1))
            if diff.size:
                tokens_per_seq = j.shape[0] // batch
                ok[diff[0] // tokens_per_seq:] = False
        self.jax.clear()
        self.port.clear()
        return ok


def model_close(label: str, got: torch.Tensor, want, rows: np.ndarray, tol=MODEL_TOL) -> None:
    np.testing.assert_allclose(f32(got)[rows], f32(want)[rows], err_msg=label, **tol)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_matches_jax(arch, monkeypatch):
    """forward's logits and aux loss, prefill's last logits and cache (k, v,
    length), then 4 decode steps fed the JAX package's tokens, on 4
    sequences of 12 + 4 tokens, within MODEL_TOL (see the module's
    docstring for the MoE configs)."""
    jcfg, tcfg = cfg_pair(arch)
    jp, tp = jax_params(jcfg)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    routing = Routing(monkeypatch)
    rows = {}

    jl, ja = j_tfm.forward(jp, jcfg, jnp.asarray(toks))
    tl, ta = t_tfm.forward(tp, tcfg, torch.from_numpy(toks))
    rows["forward"] = routing.agree(4)
    assert tl.dtype == torch.float32 and tl.shape == (4, 16, jcfg.vocab)
    model_close("forward", tl, jl, rows["forward"])
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-2, atol=1e-6)

    jlp, jc = j_tfm.prefill(jp, jcfg, jnp.asarray(toks[:, :12]), max_len=20)
    tlp, tc = t_tfm.prefill(tp, tcfg, torch.from_numpy(toks[:, :12]), max_len=20)
    ok = routing.agree(4)
    rows["prefill"] = ok
    assert tc.length == int(jc.length) == 12 and tc.k.shape == jc.k.shape
    assert tc.k.dtype == torch.bfloat16
    model_close("prefill logits", tlp, jlp, ok)
    model_close("cache k", tc.k.transpose(0, 1), jnp.swapaxes(jc.k, 0, 1), ok, CACHE_TOL)
    model_close("cache v", tc.v.transpose(0, 1), jnp.swapaxes(jc.v, 0, 1), ok, CACHE_TOL)
    assert not tc.k[:, :, 12:].any() and not tc.v[:, :, 12:].any()
    for t in range(12, 16):
        jld, jc = j_tfm.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, t]))
        tld, tc = t_tfm.decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, t]))
        ok = ok & routing.agree(4)
        rows[f"decode {t}"] = ok
        assert tc.length == int(jc.length) == t + 1
        model_close(f"decode {t}", tld, jld, ok)
    model_close("cache k after decode", tc.k.transpose(0, 1), jnp.swapaxes(jc.k, 0, 1), ok,
                CACHE_TOL)
    compared = {k: int(v.sum()) for k, v in rows.items()}
    print(f"{arch}: sequences held to MODEL_TOL of 4: {compared}")
    if tcfg.moe is None:
        assert all(v.all() for v in rows.values())
    assert all(v.sum() >= 2 for v in rows.values()), compared


def test_decode_matches_forward():
    """tests/test_nn.py::test_decode_matches_forward on the port, with its
    tolerance: forward's logits at position t equal the logits of prefill
    over t tokens and decode steps after it (RoPE offsets, causal masking
    and the cache update in one test)."""
    cfg = t_cfgs.LMConfig(
        name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv=2, d_ff=64,
        vocab=97, act="silu", gated=True, remat=False, microbatches=1,
    )
    params = t_tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)).astype(np.int32))
    full_logits, _ = t_tfm.forward(params, cfg, tokens)
    logits_p, cache = t_tfm.prefill(params, cfg, tokens[:, :8], max_len=16)
    np.testing.assert_allclose(logits_p.numpy(), full_logits[:, 7].numpy(), rtol=0.06, atol=5e-2)
    for t in range(8, 12):
        logits_d, cache = t_tfm.decode_step(params, cfg, cache, tokens[:, t])
        np.testing.assert_allclose(logits_d.numpy(), full_logits[:, t].numpy(),
                                   rtol=0.06, atol=5e-2)
    assert cache.length == 12


def test_cache_bounds_raise():
    _, cfg = cfg_pair("minitron-8b")
    params = t_tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_len 3 < prompt length 4"):
        t_tfm.prefill(params, cfg, tokens, max_len=3)
    _, cache = t_tfm.prefill(params, cfg, tokens, max_len=5)
    _, cache = t_tfm.decode_step(params, cfg, cache, tokens[:, 0])
    with pytest.raises(ValueError, match="full"):
        t_tfm.decode_step(params, cfg, cache, tokens[:, 0])


def test_lm_params_from_numpy_keeps_dtypes():
    jcfg, _ = cfg_pair("phi3.5-moe-42b-a6.6b")
    jp = j_tfm.init(jax.random.PRNGKey(1), jcfg)
    jp["embed"] = jp["embed"].astype(jnp.bfloat16)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert np.array_equal(f32(tp["embed"]), f32(jp["embed"]))
    assert tp["layers"]["moe"]["wi"].dtype == torch.float32
    assert np.array_equal(tp["layers"]["moe"]["wi"].numpy(), np.asarray(jp["layers"]["moe"]["wi"]))
