"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip elsewhere. The JAX package is not
installed beside the card, so this file imports only the port and runs
without the repository's conftest:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import apps
from repro_torch.graph import generate
from repro_torch.kernels.hot_gather import hot_gather as kernels
from repro_torch.kernels.hot_gather import ops, ref

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def make_inputs(n, d, e, hot, seed=0):
    rng = np.random.default_rng(seed)
    prop = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, e).astype(np.int32)
    idx = np.where(rng.random(e) < 0.85, idx % max(hot, 1), idx).astype(np.int32)
    idx[::31] = -1
    return prop, idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d,e,hot", [(1000, 1, 5000, 256), (1000, 8, 4096, 256),
                                       (300, 130, 2048, 300), (4096, 16, 2048, 0)])
def test_k1_matches_plain(cuda, n, d, e, hot, dtype):
    prop, idx = make_inputs(n, d, e, hot)
    full = torch.as_tensor(prop).to(DTYPES[dtype])
    hot_t, idx_t = full[:hot].contiguous().to(cuda), torch.as_tensor(idx).to(cuda)
    before = kernels.hot_gather_hot_part.launches
    got = kernels.hot_gather_hot_part(hot_t, idx_t)
    torch.cuda.synchronize()
    assert kernels.hot_gather_hot_part.launches == before + 1
    assert torch.equal(got, ref.hot_gather_ref(hot_t, idx_t))
    on_card = ops.hot_gather(full.to(cuda), idx_t, hot_size=hot).cpu()
    on_cpu = ops.hot_gather(full, torch.as_tensor(idx), hot_size=hot)
    assert torch.equal(on_card, on_cpu)


@pytest.mark.cuda
def test_k1_semantics(cuda):
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([-1, 0, 1, 2, 5, 6, 3, 7], dtype=torch.int32)
    for cap in (None, 1):
        a = ops.hot_gather(table.to(cuda), idx.to(cuda), hot_size=2, cold_capacity=cap).cpu()
        b = ops.hot_gather(table, idx, hot_size=2, cold_capacity=cap)
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k2_matches_plain(cuda, dtype):
    g = generate.uniform(10, 6, seed=0)
    idx_t, seg_t, n_pad = ops.build_aligned_edges(g.indptr, g.indices, 64, 512)
    prop = np.random.default_rng(4).standard_normal((g.num_nodes, 24)).astype(np.float32)
    hot = torch.as_tensor(prop[: g.num_nodes // 2]).to(DTYPES[dtype]).to(cuda)
    idx, seg = torch.as_tensor(idx_t).to(cuda), torch.as_tensor(seg_t).to(cuda)
    before = kernels.hot_gather_segment_sum.launches
    got = kernels.hot_gather_segment_sum(hot, idx, seg, n_pad, 512, 64)
    want = ref.gather_segment_sum_ref(hot, idx, seg, n_pad, 512, 64)
    torch.cuda.synchronize()
    assert kernels.hot_gather_segment_sum.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_pagerank_through_k1_matches_cpu(cuda):
    g = generate.rmat(12, 8, seed=3)
    before = kernels.hot_gather_hot_part.launches
    on_card = apps.pagerank(g.device(cuda)).cpu()
    assert kernels.hot_gather_hot_part.launches > before
    on_cpu = apps.pagerank(g.device("cpu"))
    torch.testing.assert_close(on_card, on_cpu, rtol=1e-5, atol=1e-7)
