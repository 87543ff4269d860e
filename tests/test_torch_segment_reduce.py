"""repro_torch.kernels.segment_reduce: the four statistics of PNA's
aggregation (row sums of the messages and of their squares, row maxima and
minima, non-finite extremes zeroed) over a CSR's rows.

On the CPU the wrapper computes its plain version; the CPU tests hold it
bit for bit to the four calls PNA's blocked layer makes there
(``index_add_`` twice over the rows' int32 ids, ``gnn._seg_extreme_sorted``
twice), and hold the float64 check the card tests use to what it must
refuse. The card tests hold the CUDA kernel to that check (sums within the
error bound ``csrc/segment_reduce.cu`` states, extremes exact), to the CPU
path's non-finite values, and a launch to a repeat of itself bit for bit.
This file imports only the port, so the card tests run without the
repository's conftest:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_segment_reduce.py
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.segment_reduce import ref
from repro_torch.kernels.segment_reduce import segment_reduce as kernel
from repro_torch.nn import gnn

INF, NAN = float("inf"), float("nan")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def case(counts, d, seed=0):
    """Messages ``(E, d)`` float32 (standard normal) for rows of ``counts``
    messages, and the rows' int32 offsets."""
    counts = np.asarray(counts, dtype=np.int64)
    offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((int(offsets[-1]), d)).astype(np.float32)
    return torch.as_tensor(m), torch.as_tensor(offsets.astype(np.int32))


def four_calls(m, offsets):
    """What ``nn.gnn._pna_blocked`` computes on the CPU for a block whose
    rows start at 0: ``index_add_`` over the int32 ids, twice, and
    ``_seg_extreme_sorted``, twice."""
    seg = torch.repeat_interleave(torch.arange(offsets.shape[0] - 1, dtype=torch.int32),
                                  (offsets[1:] - offsets[:-1]).long())
    rows = (offsets.shape[0] - 1, m.shape[1])
    return torch.stack([m.new_zeros(rows).index_add_(0, seg, m),
                        m.new_zeros(rows).index_add_(0, seg, m * m),
                        gnn._seg_extreme_sorted(m, offsets, "amax"),
                        gnn._seg_extreme_sorted(m, offsets, "amin")])


def same_bits(a, b):
    """Equal bits, NaN where the other has NaN (its payload aside)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32), b.masked_fill(nan, 0).view(torch.int32))


def same_values(a, b):
    """Equal values (-0 equal to 0), NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.masked_fill(nan, 0),
                                                            b.masked_fill(nan, 0))


def poisoned(m):
    """``m`` with +inf, -inf and NaN planted: a row with +inf alone in a
    column, one with both infinities, one with NaN, one with NaN and +inf,
    and a NaN in the first message."""
    m = m.clone()
    m[0, 1] = NAN
    m[3, 0], m[7, 2] = INF, -INF
    m[5, 4], m[6, 4] = INF, -INF
    m[9, 3], m[10, 3] = NAN, INF
    m[-1, -1] = -INF
    return m


# row lengths of the CPU cases
SHAPES = {
    "empty_rows": [3, 0, 5, 0, 0, 1, 7, 0, 2, 9, 0, 4],
    "empty_tail": [6, 2, 9, 1] + [0] * 40,
    "hub": [1, 0, 2, 700, 1, 1, 1],
    "one_row": [513],
    "one_edge": [0, 1, 0],
}


# --- the CPU's plain path ---------------------------------------------------

@pytest.mark.parametrize("d", [75, 5])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_path_is_the_four_calls_bit_for_bit(shape, d):
    m, offsets = case(SHAPES[shape], d, seed=1)
    got = kernel.segment_stats(m, offsets)
    assert got.dtype == torch.float32 and got.shape == (4, len(SHAPES[shape]), d)
    assert same_bits(got, four_calls(m, offsets))
    assert same_bits(ref.segment_stats_ref(m, offsets), got)


def test_plain_path_keeps_the_four_calls_non_finite_values():
    m, offsets = case(SHAPES["empty_rows"], 6, seed=2)
    m = poisoned(m)
    got = kernel.segment_stats(m, offsets)
    assert same_bits(got, four_calls(m, offsets))
    # NaN in the sums; extremes zeroed wherever an infinity or NaN reached them
    assert torch.isnan(got[0, 0, 1]) and torch.isnan(got[1, 0, 1])
    assert torch.isfinite(got[2:]).all()
    assert float(got[2, 0, 1]) == 0.0 and float(got[3, 0, 1]) == 0.0


def test_empty_rows_hold_zero():
    m, offsets = case(SHAPES["empty_rows"], 4)
    got = kernel.segment_stats(m, offsets)
    empty = offsets[1:] == offsets[:-1]
    assert torch.equal(got[:, empty], torch.zeros(4, int(empty.sum()), 4))


@pytest.mark.parametrize("m,offsets,error", [
    (torch.zeros(4, 3, dtype=torch.float64), torch.tensor([0, 4], dtype=torch.int32),
     TypeError),
    (torch.zeros(4, 3), torch.tensor([0, 4]), TypeError),  # int64 offsets
    (torch.zeros(4), torch.tensor([0, 4], dtype=torch.int32), ValueError),  # 1-D m
    (torch.zeros(4, 3), torch.tensor([[0, 4]], dtype=torch.int32), ValueError),
    (torch.zeros(4, 3), torch.tensor([], dtype=torch.int32), ValueError),
    (torch.zeros(3, 4).t(), torch.tensor([0, 4], dtype=torch.int32), ValueError),  # strided
    (torch.zeros(4, 3), torch.tensor([0, 3], dtype=torch.int32), ValueError),  # ends at 3
    (torch.zeros(4, 3), torch.tensor([1, 4], dtype=torch.int32), ValueError),
    (torch.zeros(4, 3), torch.tensor([0, 4], dtype=torch.int32, device="meta"), ValueError),
    (torch.zeros(4, 3, device="meta"), torch.tensor([0, 4], dtype=torch.int32, device="meta"),
     RuntimeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(m, offsets, error):
    with pytest.raises(error):
        kernel.segment_stats(m, offsets)


def test_check_refuses_a_sum_outside_the_bound_and_a_wrong_extreme():
    """The float64 check the card tests use: it passes the plain version on
    short rows, and refuses a sum moved by 4096 roundings of its row's sum
    of magnitudes, an extreme moved by one ulp, a NaN lost or an infinity
    lost."""
    m, offsets = case(SHAPES["empty_rows"], 8, seed=3)
    good = ref.segment_stats_ref(m, offsets)
    assert ref.check(good, m, offsets)[0]
    bad = good.clone()
    mag = float(m[offsets[2]:offsets[3], 5].abs().sum())
    bad[0, 2, 5] += 4096 * ref.U * mag
    assert not ref.check(bad, m, offsets)[0]
    bad = good.clone()
    bad[2, 0, 0] = torch.nextafter(bad[2, 0, 0], torch.tensor(INF))
    assert not ref.check(bad, m, offsets)[0]
    m = poisoned(m)
    good = ref.segment_stats_ref(m, offsets)
    assert ref.check(good, m, offsets)[0]
    for plane, row, col in ((0, 0, 1), (1, 0, 1), (0, 0, 0)):
        bad = good.clone()
        bad[plane, row, col] = 1.0
        assert not ref.check(bad, m, offsets)[0]


def test_tile_items_mirror_the_kernel():
    """``ref.tile_items`` mirrors the kernel's tile: 218 items at d = 75,
    163 at 100, 2,048 at most."""
    assert (ref.tile_items(75), ref.tile_items(100), ref.tile_items(1)) == (218, 163, 2048)


# --- the kernel on the card -------------------------------------------------

HUB = 102_580  # kron21's largest in-degree
HUB_ROW = 3005  # card_case's row of HUB messages


def card_case(d, seed=0, tail_rows=20_000):
    """Rows of 0, 1, 31, 32, 33 messages, a run of 3,000 empty rows, a hub
    of ``HUB`` messages (hundreds of tiles), rows around a tile's items,
    then ``tail_rows`` rows of 0-60 messages (a third empty) and 500 empty
    rows."""
    rng = np.random.default_rng(seed)
    items = ref.tile_items(d)
    tail = rng.integers(0, 61, tail_rows)
    tail[rng.random(tail_rows) < 1 / 3] = 0
    counts = np.concatenate([[0, 1, 31, 32, 33], np.zeros(3000, dtype=np.int64), [HUB, 0],
                             [items - 1, items, items + 1, 2 * items], tail,
                             np.zeros(500, dtype=np.int64)])
    return case(counts, d, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [75, 100, 33, 7])
def test_kernel_within_bound_of_float64(cuda, d):
    m, offsets = card_case(d, seed=d)
    got = kernel.segment_stats(m.to(cuda), offsets.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == (4, offsets.shape[0] - 1, d)
    ok, worst = ref.check(got.cpu(), m, offsets)
    assert ok, worst
    empty = offsets[1:] == offsets[:-1]
    assert torch.equal(got.cpu()[:, empty], torch.zeros(4, int(empty.sum()), d))


@pytest.mark.cuda
def test_kernel_rows_across_the_carry_groups(cuda):
    """A row of 2^20 messages at d = 75 spans ~4,800 tiles, some 75 of the
    carry pass's groups of 64; shorter rows on both sides of it."""
    m, offsets = case([3, 0, 1 << 20, 5, 0, 70_000] + [1] * 2000 + [0] * 10, 75, seed=6)
    got = kernel.segment_stats(m.to(cuda), offsets.to(cuda))
    ok, worst = ref.check(got.cpu(), m, offsets)
    assert ok, worst


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_on_the_cpu_shapes(cuda, shape):
    """Empty rows, a single row, a single edge."""
    m, offsets = case(SHAPES[shape], 75, seed=4)
    got = kernel.segment_stats(m.to(cuda), offsets.to(cuda))
    ok, worst = ref.check(got.cpu(), m, offsets)
    assert got.shape == (4, len(SHAPES[shape]), 75) and ok, worst


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [1, 2, 3])
def test_kernel_on_messages_off_16_byte_alignment(cuda, lead):
    """``m`` starting 4, 8 or 12 bytes past a 16-byte boundary: the first
    tile's first quad reaches before the array and is read an element at a
    time."""
    m, offsets = card_case(75, seed=8, tail_rows=2000)
    flat = torch.empty(m.numel() + lead, device=cuda)
    moved = flat[lead:].view(m.shape)
    moved.copy_(m)
    assert moved.data_ptr() % 16 == 4 * lead
    got = kernel.segment_stats(moved, offsets.to(cuda))
    ok, worst = ref.check(got.cpu(), m, offsets)
    assert ok, worst


@pytest.mark.cuda
@pytest.mark.parametrize("d", [75, 7])
def test_kernel_keeps_the_cpu_paths_non_finite_values(cuda, d):
    """+inf, -inf and NaN in the messages: the sums hold NaN and infinities
    where the CPU path has them, and the extremes its zeros, equal value for
    value; the rest within the bound."""
    m, offsets = card_case(d, seed=9, tail_rows=2000)
    m = poisoned(m)
    m[offsets[HUB_ROW] + 17, 2] = NAN
    m[offsets[HUB_ROW] + 40_000, 3] = INF
    got = kernel.segment_stats(m.to(cuda), offsets.to(cuda)).cpu()
    want = ref.segment_stats_ref(m, offsets)
    finite = torch.isfinite(want)
    assert torch.equal(finite, torch.isfinite(got))
    assert same_values(got[~finite], want[~finite])
    assert torch.equal(got[2:], want[2:])
    ok, worst = ref.check(got, m, offsets)
    assert ok, worst


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit_and_counts_its_launches(cuda):
    m, offsets = card_case(75, seed=5)
    m, offsets = m.to(cuda), offsets.to(cuda)
    before = kernel.segment_stats.launches
    first = kernel.segment_stats(m, offsets)
    for _ in range(3):
        assert same_bits(kernel.segment_stats(m, offsets), first)
    assert kernel.segment_stats.launches == before + 4
    # no message: zeros, and no launch
    none = kernel.segment_stats(m[:0], torch.zeros(6, dtype=torch.int32, device=cuda))
    assert torch.equal(none, torch.zeros(4, 5, 75, device=cuda))
    assert kernel.segment_stats.launches == before + 4


@pytest.mark.cuda
def test_kernel_refuses_rows_wider_than_it_takes(cuda):
    m = torch.zeros(4, kernel.MAX_WIDTH + 1, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        kernel.segment_stats(m, torch.tensor([0, 4], dtype=torch.int32, device=cuda))


@pytest.mark.cuda
def test_kernel_fails_on_offsets_that_do_not_end_at_e(cuda):
    """``offsets[R] != E`` fails a device-side assert at the next wait for
    the device. It leaves the process's CUDA context unusable, so it runs
    in a process of its own."""
    code = (
        "import torch\n"
        "from repro_torch.kernels.segment_reduce.segment_reduce import segment_stats\n"
        "m = torch.ones(1001, 75, device='cuda')\n"
        "offsets = torch.tensor([0, 500, 1000], dtype=torch.int32, device='cuda')\n"
        "segment_stats(m, offsets)\n"
        "torch.cuda.synchronize()\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode != 0
    assert "device-side assert" in proc.stderr, proc.stderr[-2000:]
