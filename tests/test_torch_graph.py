"""repro_torch graph + host core vs the JAX package: generators, datasets,
CSR ops, reordering, regions, plans, traces and the state converters —
all exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hotset as j_hotset
from repro.core import plan as j_plan
from repro.core import regions as j_regions
from repro.core import reorder as j_reorder
from repro.graph import csr as j_csr
from repro.graph import datasets as j_datasets
from repro.graph import generate as j_generate
from repro.graph import traces as j_traces
from repro_torch import convert
from repro_torch.core import hotset as t_hotset
from repro_torch.core import plan as t_plan
from repro_torch.core import regions as t_regions
from repro_torch.core import reorder as t_reorder
from repro_torch.graph import csr as t_csr
from repro_torch.graph import datasets as t_datasets
from repro_torch.graph import generate as t_generate
from repro_torch.graph import traces as t_traces


def assert_same_csr(a, b):
    assert a.num_nodes == b.num_nodes
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype and a.indices.dtype == b.indices.dtype
    if a.weights is None:
        assert b.weights is None
    else:
        np.testing.assert_array_equal(a.weights, b.weights)


GENERATORS = [
    ("rmat", (9, 8), dict(seed=3)),
    ("rmat", (10, 6), dict(a=0.45, b=0.22, c=0.22, seed=0)),
    ("uniform", (9, 6), dict(seed=0)),
    ("two_level_example", (), {}),
]


@pytest.mark.parametrize("fn,args,kw", GENERATORS)
def test_generators_identical(fn, args, kw):
    assert_same_csr(getattr(j_generate, fn)(*args, **kw), getattr(t_generate, fn)(*args, **kw))


def test_uniform_weights_identical():
    j = j_generate.add_uniform_weights(j_generate.rmat(8, 4, seed=1), seed=5)
    t = t_generate.add_uniform_weights(t_generate.rmat(8, 4, seed=1), seed=5)
    assert_same_csr(j, t)


@pytest.mark.parametrize("name", sorted(j_datasets.SPECS))
def test_datasets_identical(name):
    j, t = j_datasets.load(name, scale=10), t_datasets.load(name, scale=10)
    assert_same_csr(j, t)
    for eb in (8, 16):
        assert j_datasets.scaled_llc_bytes(name, j, eb) == t_datasets.scaled_llc_bytes(name, t, eb)
    assert t_datasets.load(name, scale=10) is t  # lru_cache kept


def test_csr_ops_identical():
    j, t = j_generate.rmat(9, 8, seed=3), t_generate.rmat(9, 8, seed=3)
    assert_same_csr(j_csr.transpose(j), t_csr.transpose(t))
    assert_same_csr(j_csr.symmetrize(j), t_csr.symmetrize(t))
    rank = np.random.default_rng(0).permutation(j.num_nodes)
    assert_same_csr(j_csr.apply_reorder(j, rank), t_csr.apply_reorder(t, rank))
    np.testing.assert_array_equal(j.dst_ids(), t.dst_ids())
    np.testing.assert_array_equal(j.in_degree, t.in_degree)
    np.testing.assert_array_equal(j.out_degree, t.out_degree)
    assert j.avg_degree == t.avg_degree


def test_device_csr_matches_reference():
    jg = j_generate.add_uniform_weights(j_generate.rmat(8, 6, seed=2), seed=1)
    tg = t_generate.add_uniform_weights(t_generate.rmat(8, 6, seed=2), seed=1)
    jd, td = jg.device(), tg.device("cpu")
    assert td.num_nodes == jd.num_nodes
    for f in ("indptr", "indices", "dst"):
        assert getattr(td, f).dtype == torch.int32
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)))
    np.testing.assert_array_equal(td.weights.numpy(), np.asarray(jd.weights))


@pytest.mark.parametrize("direction", ["pull", "push"])
@pytest.mark.parametrize("technique", j_reorder.TECHNIQUES)
def test_reorder_ranks_identical(technique, direction):
    assert t_reorder.TECHNIQUES == j_reorder.TECHNIQUES
    j, t = j_datasets.load("lj", scale=10), t_datasets.load("lj", scale=10)
    np.testing.assert_array_equal(
        j_reorder.reorder_ranks(j, technique, direction),
        t_reorder.reorder_ranks(t, technique, direction),
    )
    n, m = j.num_nodes, j.num_edges
    assert j_reorder.reorder_cost_model(technique, n, m) == t_reorder.reorder_cost_model(
        technique, n, m)


def test_skew_stats_identical():
    g = j_datasets.load("pl", scale=10)
    for direction in ("pull", "push"):
        deg = j_hotset.reuse_degree(g, direction)
        assert dataclasses.asdict(j_hotset.skew_stats(deg)) == dataclasses.asdict(
            t_hotset.skew_stats(deg))
        np.testing.assert_array_equal(j_hotset.hot_mask(deg), t_hotset.hot_mask(deg))


@pytest.mark.parametrize(
    "num_elems,elem_bytes,budget,num_arrays,align",
    [(4096, 16, 16 * 1024, 1, 1), (4096, 8, 16 * 1024, 2, 1),
     (100_000, 32, 1 << 20, 1, 128), (50, 4, 1 << 20, 1, 1), (1000, 16, 0, 1, 1)],
)
def test_plan_identical_with_explicit_budget(num_elems, elem_bytes, budget, num_arrays, align):
    j = j_plan.make_plan(num_elems, elem_bytes, budget, num_arrays, align)
    t = t_plan.make_plan(num_elems, elem_bytes, budget, num_arrays, align)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.enabled, j.cold_size) == (t.enabled, t.cold_size)
    idx = np.arange(num_elems + 10)
    np.testing.assert_array_equal(j.classify_elem(idx), t.classify_elem(idx))
    addr = np.arange(0, (num_elems + 10) * elem_bytes, 4)
    np.testing.assert_array_equal(j.regions().classify(addr), t.regions().classify(addr))
    assert j_plan.entries_for_budget(budget, elem_bytes, align, num_elems) == \
        t_plan.entries_for_budget(budget, elem_bytes, align, num_elems)
    assert convert.plan_from_fields(**dataclasses.asdict(j)) == t


def test_plan_default_budget_is_the_l2(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = t_plan.make_plan(100_000_000, 4)
    assert p.budget_bytes == t_plan.H100_L2_BYTES == 50 * 1024 * 1024
    assert p.hot_size == p.moderate_size == t_plan.H100_L2_BYTES // 4
    assert p.budget_bytes != j_plan.make_plan(100_000_000, 4).budget_bytes


def test_classify_tensor_matches_numpy_and_jnp():
    regs = [([(0, 4096)], 1024), ([(0, 4096), (8192, 12288)], 2048), ([(100, 300)], 64)]
    addr = np.arange(0, 14000, 7, dtype=np.int64)
    for bounds, llc in regs:
        j = j_regions.make_regions(bounds, llc)
        t = t_regions.make_regions(bounds, llc)
        want = j.classify(addr)
        np.testing.assert_array_equal(t.classify(addr), want)
        got = t.classify_tensor(torch.as_tensor(addr))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.asarray(j.classify_jnp(jnp.asarray(addr))), want)


@pytest.mark.parametrize("app", sorted(j_traces.APPS))
def test_traces_identical(app):
    j = j_datasets.load("lj", scale=11)
    j2 = j_csr.apply_reorder(j, j_reorder.reorder_ranks(j, "dbg"))
    t2 = convert.csr_from_numpy(j2.indptr, j2.indices, j2.num_nodes)
    llc = j_datasets.scaled_llc_bytes("lj", j2, elem_bytes=16)
    jt, jp = j_traces.generate_trace(j2, app, llc, seed=4)
    tt, tp = t_traces.generate_trace(t2, app, llc, seed=4)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    for f in ("line", "hint", "pc", "region", "nxt"):
        a, b = getattr(jt, f), getattr(tt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_trace_hints_disabled_and_capped():
    j = j_datasets.load("pl", scale=10)
    t = t_datasets.load("pl", scale=10)
    jt, _ = j_traces.generate_trace(j, "pr", 16 * 1024, hints_enabled=False, max_records=5000)
    tt, _ = t_traces.generate_trace(t, "pr", 16 * 1024, hints_enabled=False, max_records=5000)
    for f in ("line", "hint", "pc", "region", "nxt"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), err_msg=f)


def test_converters_carry_reference_state():
    j = j_generate.add_uniform_weights(j_generate.rmat(8, 4, seed=7), seed=2)
    assert_same_csr(j, convert.csr_from_numpy(j.indptr, j.indices, j.num_nodes, j.weights))
    with pytest.raises(ValueError):
        convert.csr_from_numpy(j.indptr[:-1], j.indices, j.num_nodes)
    jt, _ = j_traces.generate_trace(j, "pr", 16 * 1024)
    tt = convert.trace_from_numpy(jt.line, jt.hint, jt.pc, jt.region, jt.nxt)
    for f in ("line", "hint", "pc", "region", "nxt"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f))
        assert getattr(jt, f).dtype == getattr(tt, f).dtype
    with pytest.raises(ValueError):
        convert.trace_from_numpy(jt.line, jt.hint[:-1], jt.pc, jt.region, jt.nxt)
