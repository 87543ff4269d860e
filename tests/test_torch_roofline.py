"""repro_torch's ``launch/roofline.py`` against the JAX package's: the
analytic FLOP and byte formulas over every config and shape, the
collective-byte parser and ``analyze`` over HLO text written here, all
exactly equal once the port's peak rates are set to the reference's; and
the port's own rates, one NVIDIA H100 SXM5's."""
import dataclasses

import pytest

from repro.configs import base as j_cfgs
from repro.launch import roofline as j_roof
from repro_torch.configs import base as t_cfgs
from repro_torch.launch import roofline as t_roof

CONSTANTS = ("PEAK_FLOPS", "HBM_BW", "LINK_BW")
CELLS = [(arch, shape) for arch, cfg in sorted(j_cfgs.all_archs().items())
         for shape in sorted(j_cfgs.SHAPES[cfg.family])]
LM_CELLS = [(a, s) for a, s in CELLS if j_cfgs.get_arch(a).family == "lm"]


@pytest.fixture
def reference_rates(monkeypatch):
    for name in CONSTANTS:
        monkeypatch.setattr(t_roof, name, getattr(j_roof, name))


def pair(arch: str, shape: str):
    jc, tc = j_cfgs.get_arch(arch), t_cfgs.get_arch(arch)
    return (jc, j_cfgs.SHAPES[jc.family][shape]), (tc, t_cfgs.SHAPES[tc.family][shape])


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}:{s}" for a, s in CELLS])
def test_model_flops_match_the_reference(arch, shape):
    (jc, js), (tc, ts) = pair(arch, shape)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    want = j_roof.model_flops_for(jc, js)
    assert t_roof.model_flops_for(tc, ts) == want and want > 0


@pytest.mark.parametrize("arch,shape", LM_CELLS, ids=[f"{a}:{s}" for a, s in LM_CELLS])
def test_analytic_lm_terms_match_the_reference(arch, shape):
    (jc, js), (tc, ts) = pair(arch, shape)
    for kw in (dict(num_devices=1, n_model=1), dict(num_devices=256),
               dict(num_devices=512, n_model=16, n_batch_shards=32), dict(num_devices=4, n_model=4)):
        want = j_roof.analytic_lm_terms(jc, js, **kw)
        assert t_roof.analytic_lm_terms(tc, ts, **kw) == want, kw
    scaled = dataclasses.replace(tc, microbatches=1, seq_shard=not tc.seq_shard)
    assert t_roof.analytic_lm_terms(scaled, ts, 256) == j_roof.analytic_lm_terms(
        dataclasses.replace(jc, microbatches=1, seq_shard=not jc.seq_shard), js, 256)


# Every collective op, with and without -start, a ROOT, tuple results, both
# replica_groups forms (explicit lists and the iota [G,S] form), a group of
# one (no traffic), an unknown dtype, scalars, and ops nested in while
# bodies at depths 0, 1 and 2 (op_name metadata)
HLO = """
HloModule step
  %ag = f32[8,128]{1,0} all-gather(f32[2,128]{1,0} %p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = bf16[1024]{0} all-reduce(bf16[1024]{0} %p1), replica_groups=[2,4]<=[8], to_apply=%add, metadata={op_name="jit(step)/while/body/dot"}
  %rs = f32[64,32]{1,0} reduce-scatter(f32[256,32]{1,0} %p2), replica_groups={{0,2},{1,3}}, dimensions={0}, metadata={op_name="jit(step)/while/body/while/body/add"}
  %a2a = (f32[16,8]{1,0}, s32[16]{0}) all-to-all(f32[16,8]{1,0} %p3, s32[16]{0} %p4), replica_groups={{0,1,2,3,4,5,6,7}}
  %cp = u8[4096]{0} collective-permute(u8[4096]{0} %p5), source_target_pairs={{0,1},{1,0}}
  %ags = (f32[4,4]{1,0}, f32[16,4]{1,0}) all-gather-start(f32[4,4]{1,0} %p6), replica_groups={{0,1,2,3}}, dimensions={0}
  ROOT %arr = f32[] all-reduce(f32[] %p7), replica_groups={}, to_apply=%add
  %solo = f32[999]{0} all-reduce(f32[999]{0} %p8), replica_groups={{0},{1}}, to_apply=%add
  %odd = f8e4m3fn[64]{0} all-gather(f8e4m3fn[16]{0} %p9), replica_groups={{0,1,2,3}}, dimensions={0}
  %notacoll = f32[8]{0} add(f32[8]{0} %a, f32[8]{0} %b)
"""


@pytest.mark.parametrize("devices,trips", [(8, ()), (8, (4,)), (8, (32, 3)), (4, (5, 7, 9)),
                                           (1, ())])
def test_collective_bytes_match_the_reference(devices, trips):
    want = j_roof.collective_bytes(HLO, devices, trips)
    got = t_roof.collective_bytes(HLO, devices, trips)
    assert got == want
    if devices > 1:
        assert all(v > 0 for v in want.values()), want
    assert t_roof._shape_bytes("(f32[2,3], bf16[4], pred[])") == j_roof._shape_bytes(
        "(f32[2,3], bf16[4], pred[])") == 24 + 8 + 1
    for line in HLO.splitlines():
        assert t_roof._group_size(line, devices) == j_roof._group_size(line, devices)


@pytest.mark.parametrize("analytic", [None, {"flops_per_dev": 3.5e14, "hbm_bytes_per_dev": 2e11}])
@pytest.mark.parametrize("cost", [{}, {"flops": 1.25e15, "bytes accessed": 7.5e11}])
def test_analyze_and_row_match_the_reference(cost, analytic, reference_rates):
    (jc, js), (tc, ts) = pair("minitron-8b", "train_4k")
    args = ("minitron-8b", "train_4k", "16x16", 256, cost, HLO)
    kw = dict(memory_bytes=1.5e10, loop_trips=(32,), analytic=analytic)
    want = j_roof.analyze(*args, j_roof.model_flops_for(jc, js), **kw)
    got = t_roof.analyze(*args, t_roof.model_flops_for(tc, ts), **kw)
    assert got.row() == want.row()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("dominant", "bound_s", "useful_flop_ratio", "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop
    # a zero-time cell: the ratios' guards
    zero = dict(arch="a", shape="s", mesh="m", num_devices=1, hlo_gflops=0.0, hlo_gbytes=0.0,
                coll_gbytes=0.0, compute_s=0.0, memory_s=0.0, collective_s=0.0,
                model_gflops=1.0)
    assert t_roof.Roofline(**zero).row() == j_roof.Roofline(**zero).row()


def test_the_ports_rates_are_the_h100s():
    """bf16 dense tensor-core peak 989.4 TFLOP/s, HBM3 at 3.35 TB/s, NVLink 4
    at 450 GB/s a direction (900 GB/s both ways); none is the TPU's."""
    assert (t_roof.PEAK_FLOPS, t_roof.HBM_BW, t_roof.LINK_BW) == (989.4e12, 3.35e12, 450e9)
    assert all(getattr(t_roof, n) != getattr(j_roof, n) for n in CONSTANTS)
    r = t_roof.analyze("a", "s", "one", 1, {"flops": 989.4e12, "bytes accessed": 3.35e12}, "", 0.0)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 0.0)
