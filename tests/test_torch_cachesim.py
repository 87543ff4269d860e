"""repro_torch LLC simulator + policies vs the JAX package: every ported
policy's hits_by_hint bit for bit, and the paper's claims end to end."""
import numpy as np
import pytest

from repro.core import cachesim as j_cachesim
from repro.core.reorder import reorder_ranks
from repro.graph import datasets, traces
from repro.graph.csr import apply_reorder
from repro_torch import convert
from repro_torch.core import cachesim as t_cachesim
from repro_torch.core import policies as t_policies
from repro_torch.graph import datasets as t_datasets
from repro_torch.graph import traces as t_traces
from repro_torch.core.reorder import reorder_ranks as t_reorder_ranks
from repro_torch.graph.csr import apply_reorder as t_apply_reorder

PORTED = ("lru", "rrip", "rrip_hints", "grasp_insert", "grasp", "opt")
LLC = 16 * 1024  # 16 sets x 16 ways x 64B


def to_port(tr):
    return convert.trace_from_numpy(tr.line, tr.hint, tr.pc, tr.region, tr.nxt)


@pytest.fixture(scope="module")
def graph_trace():
    g = datasets.load("lj", scale=12)
    g2 = apply_reorder(g, reorder_ranks(g, "dbg"))
    llc = datasets.scaled_llc_bytes("lj", g2, elem_bytes=16)
    tr, _ = traces.generate_trace(g2, "pr", llc, max_records=150_000)
    return tr, llc


@pytest.fixture(scope="module")
def mixed_trace():
    """Zipf lines with all four hints, so every insertion/promotion path and
    the DRRIP set duel (Default hints) are exercised."""
    rng = np.random.default_rng(0)
    lines = rng.zipf(1.2, 30_000) % 8192
    hints = rng.integers(0, 4, 30_000).astype(np.int8)
    pcs = rng.integers(0, 4, 30_000).astype(np.int32)
    return j_cachesim.finalize_trace(lines, hints, pcs)


@pytest.mark.parametrize("policy", PORTED)
def test_hits_by_hint_identical_on_graph_trace(graph_trace, policy):
    tr, llc = graph_trace
    want = j_cachesim.simulate(tr, policy, llc)
    got = t_cachesim.simulate(to_port(tr), policy, llc)
    np.testing.assert_array_equal(got.hits_by_hint, want.hits_by_hint)
    np.testing.assert_array_equal(got.accesses_by_hint, want.accesses_by_hint)
    assert (got.hits, got.misses, got.accesses) == (want.hits, want.misses, want.accesses)


@pytest.mark.parametrize("ways", [16, 4])
@pytest.mark.parametrize("policy", PORTED)
def test_hits_by_hint_identical_on_mixed_hints(mixed_trace, policy, ways):
    want = j_cachesim.simulate(mixed_trace, policy, LLC, ways=ways)
    got = t_cachesim.simulate(to_port(mixed_trace), policy, LLC, ways=ways)
    np.testing.assert_array_equal(got.hits_by_hint, want.hits_by_hint)


@pytest.mark.parametrize("policy", ["ship_mem", "hawkeye", "leeway", "pin_25", "pin_100"])
def test_unported_policies_raise_keyerror(mixed_trace, policy):
    assert policy not in t_policies.POLICIES
    with pytest.raises(KeyError, match=policy):
        t_cachesim.simulate(to_port(mixed_trace), policy, LLC)


def test_trace_helpers_identical():
    rng = np.random.default_rng(3)
    lines = rng.integers(0, 500, 4000)
    np.testing.assert_array_equal(t_cachesim.compute_next_use(lines),
                                  j_cachesim.compute_next_use(lines))
    hints = rng.integers(0, 4, 4000)
    pcs = rng.integers(0, 4, 4000)
    a = j_cachesim.finalize_trace(lines, hints, pcs)
    b = t_cachesim.finalize_trace(lines, hints, pcs)
    for f in ("line", "hint", "pc", "region", "nxt"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


def test_lru_and_opt_semantics_tiny():
    s = 16  # lines spaced by the set count all map to set 0
    fit = t_cachesim.finalize_trace(np.tile(np.arange(16) * s, 2), np.full(32, 3), np.zeros(32))
    assert t_cachesim.simulate(fit, "lru", LLC).hits == 16
    over = np.tile(np.arange(17) * s, 4)
    over_t = t_cachesim.finalize_trace(over, np.full(over.shape, 3), np.zeros(over.shape))
    assert t_cachesim.simulate(over_t, "lru", LLC).hits == 0  # classic LRU thrash
    assert t_cachesim.simulate(over_t, "opt", LLC).hits > 0


def test_simulate_rejects_non_power_of_two_sets(mixed_trace):
    with pytest.raises(ValueError, match="power of two"):
        t_cachesim.simulate(to_port(mixed_trace), "lru", 3 * 16 * 64)


def test_paper_claims_end_to_end():
    """tests/test_system.py::test_grasp_pipeline_end_to_end on the port alone:
    GRASP < RRIP < LRU misses, OPT < GRASP, speed-up proxy > 1, with the
    same counts as the JAX package."""
    g = t_datasets.load("pl", scale=13)
    g2 = t_apply_reorder(g, t_reorder_ranks(g, "dbg"))
    llc = t_datasets.scaled_llc_bytes("pl", g2, elem_bytes=16)
    tr, plan = t_traces.generate_trace(g2, "pr", llc, max_records=500_000)
    res = {p: t_cachesim.simulate(tr, p, llc) for p in ("rrip", "grasp", "opt", "lru")}
    assert res["grasp"].misses < res["rrip"].misses
    assert res["opt"].misses < res["grasp"].misses
    assert res["rrip"].misses < res["lru"].misses
    pm = t_cachesim.PerfModel()
    assert pm.speedup(res["rrip"], res["grasp"]) > 1.0
    assert res["rrip"].accesses_by_hint[:2].sum() > 0

    jg = datasets.load("pl", scale=13)
    jg2 = apply_reorder(jg, reorder_ranks(jg, "dbg"))
    jtr, _ = traces.generate_trace(jg2, "pr", llc, max_records=500_000)
    want = {p: j_cachesim.simulate(jtr, p, llc) for p in res}
    for p in res:
        np.testing.assert_array_equal(res[p].hits_by_hint, want[p].hits_by_hint)
    jpm = j_cachesim.PerfModel()
    assert pm.speedup(res["rrip"], res["grasp"]) == jpm.speedup(want["rrip"], want["grasp"])
    assert pm.runtime(res["lru"], res["opt"]) == jpm.runtime(want["lru"], want["opt"])
