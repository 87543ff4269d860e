#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --only 16     # the set-up, then phase 16 alone
    python3 chip_smoke.py --only 18     # the segment sum at the PRD cells' shapes
    python3 chip_smoke.py --only 19     # GAT's attention at the kron21.gat cell's shapes
    python3 chip_smoke.py --only 20     # DeeperGCN's aggregation in the kron21.deepergcn cell


Phases, each of which must pass:
  1. build the kernels from src/repro_torch/csrc/ with nvcc (one process
     per source, all at once) and print the card's name and power limit;
  2. K1 (hot gather) against its plain version on the card, bit for bit,
     in its hot-part and two-tier modes (the latter without and with cold
     ranks, on streams with -1 and >= N mixed in): the quickstart's
     PageRank (N,) f32 and step-5 (N, 8) f32, every row layout ((N, 1)
     bf16, (N, 3) f32, (N, 64) f32 and bf16, (N, 130) bf16), PageRank's
     (N,) f32 on the real-size graph, index views off 16-byte alignment,
     and the -1 / >= N / cold-overflow / 1-D semantics; the two-tier route
     at real size under CUDA's sync debug mode (no host sync);
  3. K2 (fused gather + segment-sum) against its plain version
     (rtol = atol = 1e-5: the summation order differs) on the layout's
     sorted tiles and on tiles shuffled within themselves, two launches
     bit-identical, and its own path, the aligned pull sum, against the
     engine's pull;
  4. the quickstart pipeline (examples/quickstart_torch.main("cuda")) with
     PageRank through K1 and the segment-sum kernel (once an iteration
     each), against the same PageRank on the CPU, and the paper's orderings;
  5. PageRank at real size (``lj`` at scale 22: 4.19M vertices) through K1
     against PageRank with the plain gather on the card, six runs of each,
     each launching the segment-sum kernel once an iteration;
  6. K3 (hot embedding bag) against its plain versions, bit for bit, in
     its hot-part and two-tier modes (the latter without and with cold
     ranks, on bags with -1 and >= V ids mixed in): the JAX package's
     sweep shapes (f32, and bf16), all-masked, and MIND's serve_p99 and
     serve_bulk (Zipf 1.1 ids, 0.9 mask, the L2-sized hot prefix); then
     K3's own path, ops.hot_bag at serve_bulk, one launch under CUDA's sync
     debug mode (no host sync), against bag_ref (1e-5);
  7. MIND at full width (2^21 x 64 f32 items): serve_scores through K1
     against the plain route at serve_p99, and retrieval_scores at
     retrieval_cand (2^18 hot rows, overflowing cold refs) against the
     same function on the CPU (1e-5);
  8. MIND served through the GRASP embedding cache (run_recsys_stream,
     8,192 requests, batches of 512): GRASP's hit rate beats unpinned RRPV
     and LRU, the first batch's scores match the dense forward (1e-5), K1
     runs once per lookup with hot references (never unpinned); then one
     run with measured service time for requests/s, e2e p50/p99, the
     lookup/forward split and peak device memory;
  9. the graph suite: (a) examples/graph_suite_torch.main("tw", 13) on the
     card (PageRank and PageRank-Delta through K1, SSSP, BC, Radii in both
     orders, then RRIP vs GRASP on each app's trace), each app's output
     against the same function on the CPU (SSSP, BC's level and sigma,
     Radii exact; PRD rtol 1e-4 atol 1e-7; BC's delta rtol 1e-4), K1 and
     the segment-sum kernel launched once per PR and PRD iteration; (b)
     all 13 LLC policies on the quickstart's PR trace: the hit accounting
     holds and OPT misses least (no other order is asserted); (c) at real
     size (the ``lj`` graph of phase 5): PRD through K1 against the plain
     gather (rel 1e-4, K1 and the segment-sum kernel once per iteration),
     SSSP from 0 (no edge relaxes further, the segment-min kernel once per
     iteration), BC from 0 (its levels are the hop
     distances of a unit-weight SSSP within 64 hops, sigma >= 1 where
     reached) and Radii from roots 0..7 (bit 0 set exactly where BC
     reached, radii >= level), each with its wall ms, iterations and peak
     device memory; then SSSP from 0's iterations replayed, each
     iteration's candidates reduced by the segment-min kernel and held bit
     for bit against its plain version, and timed beside it and beside
     scatter_reduce_ amin over int64 targets widened once;
 10. GIN (gin-tu at full width) served through the GRASP feature cache
     (GNNServeEngine) over the ``lj`` graph of phase 5, the JAX package's
     stand-in for ogb_products, with 100-wide seeded features: 8,192
     requests of 4 seeds, batches of 1,024 seeds sampled with fanout
     (15, 10), a 256 MiB cache as GRASP (pinned) and as unpinned RRPV and
     LRU, all requests submitted at once and served on the real clock;
     every request completes with finite (4, 16) logits, one batch's
     forward_blocks equals GIN over the densely gathered features on the
     card (rtol 1e-5, atol 1e-6) and the port on the CPU (rtol 1e-4, atol
     1e-5), K1 on that batch's hot ids is its plain version bit for bit and
     runs once per batch under GRASP (never unpinned); it prints requests/s,
     e2e p50/p99, the hit rates, the per-batch split (sampling and cache
     lookup on the host, the forward on the card) and peak device memory;
 11. training, which launches no kernel (K1's, K2's and K3's counts stay
     0), run after the kernels' timing: (a) one AdamW step of each GNN
     (GIN, PNA, EGNN, NequIP) at full width on the molecule shape, on the
     card against the CPU (the loss, every gradient leaf against its
     scale, AdamW against the CPU's of the same gradients; the step is
     value_and_grad and AdamW bit for bit); (b) MIND at full width at
     train_batch: the loss and every gradient on 4,096 rows against the
     CPU, Trainer.fit for 10 steps (finite losses; ms a step, host ms to
     draw a batch, the copy to the card, the device's busy share, peak
     memory), 20 steps on one batch (the loss falls); (c) GIN on
     minibatch_lg blocks of the ``lj`` graph, 12 steps clean and with
     checkpoints every 4 and failures at 5 and 9: two restarts, and the
     same losses and final state bit for bit under deterministic
     algorithms;
 12. GRASP-partitioned GIN training (dist.collectives) on one NCCL rank of
     a world-size-1 process group, which launches no kernel either (the
     counts stay 0): (a) gin-tu at full width, d_feat 100, through
     launch.steps.gnn_train_step's GRASP branch over the ``lj`` graph of
     phase 5 (the cell's spec over its counts; no edge dropped): one step
     against the unpartitioned gnn_loss and AdamW on the same weights on
     the card (loss within 1e-5 relative, each new parameter leaf within
     1e-5 of its largest entry), then 4 steps of each schedule (ms a step,
     peak memory) and one profiled step's top kernels; (b) the pipelined
     and the sequential schedule, 3 steps each, bit for bit under
     deterministic algorithms on ``lj`` at scale 16; (c) one step on the
     quickstart's ``tw`` graph on the card against a gloo rank on the CPU
     (phase 11's GIN tolerances);
 13. the gateway and seeded chaos (repro_torch.gateway, repro_torch.chaos)
     over MIND's serve engine on the card at full width (phase 7's
     parameters, phase 8's 128 MiB cache, batches of up to 32), run after
     the other paths' kernel timing: (a) 16 client threads send 2,048
     Zipf-1.1 requests (50-item histories, 16 candidates) to a supervised
     gateway with the breaker on: all served, each response the engine's
     output bit for bit and the dense serve_scores within 1e-5, K1 once per
     lookup with hot references and bit for bit on one batch's hot ids;
     it prints requests/s, client and server p50/p99, the hit rate, the
     per-batch split and peak memory, then the card's busy share over 512
     more requests under torch.profiler; (b) benchmarks/chaos_smoke.py's
     fault schedule (seed 42) from 4 workers: every request one outcome,
     admitted = completed + shed + failed, a restart per injected pump
     crash, a post-reset retry replayed from the dedupe, every failure an
     injected fault; (c) the breaker: 3 requests pay a 500, the rest a 503
     without a forward, and a probe after the cooldown closes it with (a)'s
     scores; (d) (b)'s schedule twice with one worker: equal injection logs
     and outcomes; (e) a warm restart from the drained snapshot rebuilds
     the cache's blocks on the card, and its probe hit rate is at most 1
     point below the pre-restart rate and at least a cold start's; (f)
     ``python -m repro_torch.launch.serve --engine recsys --gateway`` in a
     subprocess serves one request on the card, drains on SIGINT, exits 0;
 14. LM serving (nn.transformer, serve.engine.LMServeEngine and lm_loop,
     the serve CLI's --engine lm), which launches no kernel (the counts
     stay 0), after phase 12 with its tensors gone: (a) minitron-8b at its
     published width and depth (7,734,558,720 float32 parameters drawn on
     the card): lm_loop(smoke=False) at the CLI's defaults (16 requests,
     batches of 8, prefill 64, decode 32; tok/s, batch p50/p99), then
     LMServeEngine(smoke=False) serving 16 queued requests, prefill and
     decode-step ms by CUDA events beside the decode step's weight-traffic
     bound, one batch's busy share and top kernels under torch.profiler,
     peak memory; (b) prefill over 8 tokens and 4 decode steps against
     forward's logits at full depth (tests/test_nn.py's
     test_decode_matches_forward: rtol 0.06, atol 5e-2, or twice the
     card's own floor: forward at other lengths, up to 0.13 on logits of
     ~6); (c) its first 2 layers at full width on the card against the CPU
     on 2 prompts of 64 tokens: prefill and 4 decode steps' logits within
     2% of the largest CPU logit (tests/test_torch_lm.py's 2e-2 on logits
     of up to 0.73), greedy tokens equal wherever the CPU's top-1/top-2
     margin is clear of it; (d) prefill_32k cut to batch 1: one
     sequence of 32,768 tokens (ms, peak memory, finite logits), and layer
     0's chunked attention at 4,096 tokens against one chunk (1e-2); (e)
     phi3.5-moe-42b-a6.6b at its published width, 4 of 32 layers: 8 x 64
     tokens and 8 decode steps on the card, finite, then 2 layers card
     against CPU as in (c) over the sequences both route alike, and layer
     by layer on the CPU's hidden states over the tokens both route alike
     (at least 90%); (f)
     ``python -m repro_torch.launch.serve --engine lm`` on the card, then
     with ``--gateway``: one /v1/generate, SIGINT, exit 0;
 15. LM training (nn.transformer.loss_fn, launch.steps.lm_train_step, the
     donated optimizer update, Trainer, launch.train), which launches no
     kernel either (the counts stay 0), after phase 14's tensors are gone:
     (a) minitron-8b at its published width, 4 of 32 layers (per-layer
     remat), on train_4k's 4,096 positions at a global batch of 8 (8
     microbatches of one sequence): the donated step (AdamW, float32
     moments), one warm-up and 3 timed steps by CUDA events, with ms a
     step, tokens/s, MFU (launch.roofline.model_flops_for over the step at
     roofline.PEAK_FLOPS), analytic_lm_terms' bound and the step's
     fraction of it, peak memory against the 16 B a parameter of state,
     and one microbatch's busy share and top kernels under torch.profiler;
     finite losses; (b) 1 layer at full width on the card against the CPU
     on 2 x 128 positions: the loss within 1e-3 and every gradient leaf
     within 5e-2 of its largest entry (tests/test_torch_lm_train.py's
     bounds against the JAX package), beside the CPU's own gradients under
     1e-7 relative noise on the embedding; (c) under deterministic
     algorithms, donated against undonated Trainer.fit steps for SGD,
     AdamW (float32 and bfloat16 moments) and Adafactor, and a donated fit
     with two injected failures against a clean one, bit for bit; (d)
     examples/train_lm_torch.py (300 steps, a failure at 120): the loss
     falls; (e) ``python -m repro_torch.launch.train --smoke --steps 10
     --fail-at 4 --ckpt DIR`` in a subprocess: exit 0, a checkpoint of
     step 10;
 16. the mesh and sharding layer (launch.mesh, dist.sharding, the cells of
     launch.steps, checkpoint.restore(shardings=), Trainer(mesh=),
     launch.dryrun), which launches no kernel (the counts stay 0), on an
     NCCL world-size-1 group and make_debug_mesh(1, 1) on the card, after
     phase 15's tensors are gone: (a) the minitron-8b train_4k cell at
     phase 15 (a)'s cuts (4 of 32 layers, global batch 8), ms a step and
     peak memory, its first step against lm_train_step's from the same
     seed and batch (bit for bit on a 1 x 1 mesh, else within phase 15
     (b)'s loss bound and AdamW's lr); (b) the decode_32k cell at full
     width and depth, bfloat16 weights, batch 4, caches of 32,768
     positions filled to 32,000: one step against tfm.decode_step, logits
     and caches, then ms a step of both; (c) the prefill_32k cell at batch
     1 against tfm.prefill (last logits and cache; seconds); (d)
     checkpoint.restore(shardings=) onto the mesh (DTensors on the card,
     the saved bits) and Trainer(mesh=, in_shardings=, out_shardings=) 3
     steps bit for bit against the unsharded Trainer under deterministic
     algorithms; (e) ``python -m repro_torch.launch.dryrun --mesh both``
     over minitron-8b's three LM cells, gin-tu:molecule,
     mind:retrieval_cand, mind:train_batch, nequip:ogb_products and
     moonshot-v1-16b-a3b:decode_32k: every cell "ok", each record printed;
 17. PNA inference over a whole graph, run after phase 13: the benchmark
     cell kron21.pna's forward (gbench/apps/pna.py: the kron21 graph, 2.1M
     vertices and 63.5M edges, PNA at its published widths, features and
     weights from one seed) through nn.gnn.apply's blocked layer: K1
     launched once a block and layer, finite logits, the forward's seconds
     and peak memory; every K1 launch of layers 0 and 1 (d = 100, 400-byte
     rows, and d = 75, 300-byte rows) bit for bit against
     hot_gather_two_tier_ref on the path's own rows, ids and hot_size, then
     K1's numbers at both widths on those launches; the same forward
     launches segment_stats (PNA's aggregation, csrc/segment_reduce.cu)
     once a block and layer, a second forward holds each launch against
     its float64 check (sums within the kernel's error bound, extremes
     exact) and relaunches it bit for bit, then its times on the last
     layer's blocks beside its byte bound, the plain version and the four
     library calls it replaced;
 18. the segment-sum kernel (PageRank-Delta's and PageRank's pull sum) on
     the graphs of the cells kron25.prd and urand25.prd (scale 25, 1.05e9
     and 1.07e9 edges): apps.pagerank_delta there launches it once an
     iteration (the count its kernels-line entry reports); over PRD's first
     messages, two launches bit for bit,
     every row within the kernel's error bound of its float64 sum and the
     plain version within its own; then its times beside its byte bound,
     the plain version and index_add_ over the CSR's dst;
 19. GAT inference over a whole graph: the benchmark cell kron21.gat's
     forward (gbench/apps/gat.py: the kron21 graph, GAT at the
     ogbn-products widths, features and weights from one seed) through
     nn.gnn.apply's CSR route: gat_attend launched once a layer (3), finite
     logits, the forward's seconds and peak memory; then a second forward
     whose every gat_attend launch is held, on its own card tensors,
     against ref.gat_attend_ref in float64 within ref.error_bound (the card
     tests' bound) and relaunched bit for bit; then the kernel's times at
     both row widths (2 KB and 752 B) beside its byte bound and the plain
     version;
 20. DeeperGCN inference over a whole graph: the benchmark cell
     kron21.deepergcn's forward (gbench/apps/deepergcn.py: the kron21 graph,
     DeeperGCN at the ogbn-products widths, features and weights from one
     seed, the norms fitted by the float64 reference) through nn.gnn.apply's
     CSR route: softmax_aggr launched once a layer (14), the logits within
     the cell's logit_err limit of that reference, the forward's seconds
     and peak memory; then a second forward whose every softmax_aggr launch
     is held, on its own card tensors, against ref.softmax_aggr_ref in
     float64 within ref.error_bound and relaunched bit for bit; then the
     kernel's times at the 512 B rows beside its byte and exponential
     bounds and the plain version.
Each path that reaches a kernel is driven with the kernel's launch count
set to 0 just before it and read just after. The kernels' times are taken
at each path's own shapes, weighted by its launches: event-timed, device
time by torch.profiler, and host microseconds per call. K1's and K3's are
those of the mode the path launches: two-tier where it goes through
ops.hot_gather or ops.hot_bag (the quickstart, PageRank, serve_scores, the
bag, real-size PageRank-Delta, PNA's blocked layer), hot part in the serve
caches (MIND's, GIN's and the gateway's). Each phase prints its wall time.
Then one JSON line of per-kernel numbers, the card line again, and the
final {"ok": true, ...} line. It exits non-zero, printing no result, when
CUDA is unavailable or the repository's sources are missing.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "examples"))

from gbench.peaks import FP32_FLOPS, HBM_BYTES_PER_S  # noqa: E402
from gbench.trace import spin_pad  # noqa: E402

REAL_SCALE = 22               # lj: 4.19M vertices vs LiveJournal's 5M (paper Table V)
PR_ITERS = 20
PRD_TURNS = ("hot", "plain", "plain", "hot") * 3   # real-size PageRank-Delta runs
# MIND through the GRASP cache: 8,192 requests in batches of 512, a 128 MiB
# cache (a quarter of the 512 MiB table); retrieval's table split at 2^18 rows
MIND_REQUESTS = 8192
MIND_MAX_BATCH = 512
MIND_CACHE_BYTES = 128 << 20
RETRIEVAL_HOT_ROWS = 1 << 18
# the gateway over MIND's serve engine (phase 13): (a) 16 client threads in a
# closed loop send 2,048 requests of a 50-item Zipf-1.1 history and 16
# Zipf-1.1 candidates to a supervised gateway with the breaker on, batches of
# up to 32 through phase 8's 128 MiB cache; then 512 more under the profiler
GW_REQUESTS = 2048
GW_CLIENTS = 16
GW_CANDIDATES = 16
GW_MAX_BATCH = 32
GW_MAX_QUEUE = 256
GW_BUSY_REQUESTS = 512
GW_JOIN_S = 120.0
# (b)-(d): benchmarks/chaos_smoke.py's fault schedule, supervisor and breaker
# (copied: this script imports nothing of the JAX package), 192 requests
CHAOS_REQUESTS = 192
CHAOS_WORKERS = 4
CHAOS_FAULTS = dict(seed=42, forward_error_rate=0.06, latency_spike_rate=0.05,
                    latency_spike_s=0.02, pump_crash_rate=0.04, conn_reset_rate=0.08)
CHAOS_SUPERVISOR = dict(check_interval_s=0.005, wedge_timeout_s=10.0, backoff_s=0.01,
                        backoff_cap_s=0.05, crash_loop_threshold=10_000)
CHAOS_BREAKER = {"failure_threshold": 3, "cooldown_s": 0.1}
BREAKER_REQUESTS, BREAKER_THRESHOLD, BREAKER_COOLDOWN_S = 10, 3, 0.2
# (e): warm the cache on 512 requests, then probe its hit rate on 256
WARM_REQUESTS, PROBE_REQUESTS = 512, 256
# GIN served through the GRASP feature cache over the lj graph of phase 5
# (ogb_products' stand-in), with ogb_products' d_feat and minibatch_lg's
# fanout and 1,024 seeds a batch; a 256 MiB cache (16% of the table)
GNN_D_FEAT = 100
GNN_REQUESTS = 8192
GNN_SEEDS_PER_REQ = 4
GNN_MAX_BATCH = 256
GNN_FANOUT = (15, 10)
GNN_CACHE_BYTES = 256 << 20
# training (phase 11): MIND's card-vs-CPU check on the first rows of one
# train_batch, its fit lengths; GIN's fit with checkpoints and failures
TRAIN_MIND_CHECK_ROWS = 4096
TRAIN_MIND_STEPS = 10
TRAIN_MIND_FIXED_STEPS = 20
TRAIN_GIN_STEPS = 12
TRAIN_GIN_CKPT_EVERY = 4
TRAIN_GIN_FAIL_AT = (5, 9)
# card against CPU: the loss and AdamW at tests/test_torch_gnn.py's
# tolerances (MIND's 1e-5); each gradient leaf's max abs difference within
# TRAIN_GRAD_SCALE of the leaf's largest entry (check_gnn_train_steps says
# why; NequIP's is tests/test_torch_gnn.py's bound against the JAX package)
TRAIN_TOL = {"gin": 1e-5, "pna": 5e-5, "egnn": 5e-5, "nequip": 2e-3, "mind": 1e-5}
TRAIN_GRAD_SCALE = {"gin": 1e-5, "pna": 5e-3, "egnn": 5e-5, "nequip": 2.0 ** -5, "mind": 1e-5}
# GRASP-partitioned GIN training (phase 12): steps a schedule is timed over
# (the first not counted); the steps and the lj scale of the bit-for-bit
# check of the two schedules (deterministic index_add_ adds each run of one
# index serially, 0.7 ms per 1,000 pads into row 0: scripts/
# index_add_pad_runs.py; scale 22's 28.6M pads would take ~20 s a call);
# the hot prefix of the card-vs-CPU check on the tw graph
GRASP_STEPS = 4
GRASP_EXACT_STEPS = 3
GRASP_EXACT_SCALE = 16
GRASP_CHECK_HOT = 1024
# the GRASP step against the unpartitioned one at real size: each summed
# gradient leaf and new parameter leaf within this share of the leaf's
# largest entry. The card's atomic sums alone move one step's gradients by
# up to 9.6e-5 of a leaf and its new parameters by up to 2.8e-4 from run to
# run at this size (GIN's scalar eps gradient is a sum over 4.19M x 64
# terms that cancel to 4e-4; AdamW's first step divides each entry by its
# magnitude), in the unpartitioned step as in the GRASP step
# (scripts/grasp_step_noise.py); the loss comes out the same bits
GRASP_REAL_LEAF_BOUND = 1e-3
# phase 14: LM serving. minitron-8b at the serve CLI's defaults; phi3.5-MoE
# cut to 4 of its 32 layers (float32 weights of all 32: 174 GB); the CPU
# checks cut to 2 layers at full width (a CPU run of the whole depth would
# take most of the phase's time)
LM_ARCH = "minitron-8b"
LM_REQUESTS, LM_BATCH, LM_PREFILL, LM_DECODE = 16, 8, 64, 32
LM_MOE_ARCH = "phi3.5-moe-42b-a6.6b"
LM_MOE_LAYERS = 4
LM_CPU_LAYERS = 2
LM_TF_TOL = dict(rtol=0.06, atol=5e-2)     # tests/test_nn.py::test_decode_matches_forward
# card vs CPU: tests/test_torch_lm.py holds logits of up to 0.73 to atol 2e-2
# (2.7% of the largest); at full width they reach ~6 and the bfloat16
# roundings scale with them, so the bound is 2% of the largest CPU logit
LM_CPU_REL = 2e-2
# phase 15: LM training. minitron-8b at published width on train_4k's
# 4,096 positions, cut to 4 of its 32 layers and a global batch of 8 (of
# 256). Below 8e9 parameters for_arch gives float32 moments, so the
# parameters, the two moments and the gradient sum take 16 B a parameter:
# 44.8 GB at 4 layers, 124 GB at 32. A batch of 8 is what the cell makes of
# its 8 microbatches on one card: one sequence each. The card-vs-CPU check
# at 1 layer and 2 x 128 positions; donation and restarts bit for bit at
# examples/train_lm.py's width.
LM_TRAIN_LAYERS = 4
LM_TRAIN_BATCH = 8
LM_TRAIN_TIMED = 3
LM_TRAIN_CPU_LAYERS = 1
LM_TRAIN_CPU_BATCH, LM_TRAIN_CPU_SEQ = 2, 128
# tests/test_torch_lm_train.py's bounds of the port against the JAX package
# (another implementation's roundings of the same bfloat16 products)
LM_TRAIN_LOSS_ATOL = 1e-3
LM_TRAIN_GRAD_REL = 5e-2
LM_TRAIN_SMALL = dict(n_layers=2, d_model=256, n_heads=8, n_kv=4, d_ff=1024, vocab=4096)
# phase 16: the mesh and sharding layer
MESH_DECODE_BATCH = 4          # decode_32k's 128 cut: two 17.2 GB caches for the comparison
MESH_DECODE_LENGTH = 32000     # the cache's filled prefix (of 32,768 positions)
MESH_DRYRUN_CELLS = ("minitron-8b:train_4k,minitron-8b:prefill_32k,minitron-8b:decode_32k,"
                     "gin-tu:molecule,mind:retrieval_cand,"
                     # the cells the local rules LocalTake, local_edge_map and
                     # local_decode carry (the card's torch refuses DTensor's own)
                     "mind:train_batch,nequip:ogb_products,moonshot-v1-16b-a3b:decode_32k")
MESH_DRYRUN_TIMEOUT = 400


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def build_all() -> None:
    """Build every kernel source at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        for lib in pool.map(_build.build, names):
            print(f"built {lib.name}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float | None:
    """Mean device time of ``fn`` per call: the self device time of every
    kernel it launched over ``reps`` calls, read with torch.profiler in a
    window padded by ``spin_pad``. None where it saw no device time, or a
    count of kernels that is not a multiple of ``reps`` (each call launches
    the same kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spin_pad()
        for _ in range(reps):
            fn()
        spin_pad()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key]
    busy = sum(e.self_device_time_total for e in kernels)
    seen = sum(e.count for e in kernels)
    if seen % reps:
        print(f"device_ms: the profiler saw {seen} kernels for {reps} calls: "
              + ", ".join(f"{e.key[:48]} x{e.count}" for e in kernels))
    return busy / 1e3 / reps if busy > 0 and seen % reps == 0 else None


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn``, over ``calls`` calls and one
    synchronise: the rate the host issues them at, unless the card is slower."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """(least time in ms, what bounds it) on the H100 at its published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a, b) -> bool:
    """Equal values with NaN in the same places."""
    import torch

    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def dbg_graph(name: str, scale: int):
    from repro_torch.core.reorder import reorder_ranks
    from repro_torch.graph import datasets
    from repro_torch.graph.csr import apply_reorder

    g = datasets.load(name, scale=scale)
    return apply_reorder(g, reorder_ranks(g, "dbg"))


def check_k1(dev, qs_graph, real_graph) -> tuple[dict, dict]:
    """Hold K1 against its plain version, bit for bit, at each path's shapes.

    Returns the launch mix of each path that reaches K1, as
    ``{path: [(prop (N, d) on the card, hot_size, idx), ...]}``, and
    each path's largest error against the plain version."""
    import numpy as np
    import torch

    from repro_torch.core import make_plan
    from repro_torch.graph import datasets
    from repro_torch.kernels.hot_gather import ops, ref
    from repro_torch.kernels.hot_gather.hot_gather import (
        hot_gather_hot_part,
        hot_gather_two_tier,
    )

    rng = np.random.default_rng(0)
    qs_idx = torch.as_tensor(qs_graph.indices).to(dev)
    n = qs_graph.num_nodes
    llc = datasets.scaled_llc_bytes("tw", qs_graph, elem_bytes=16)
    qs_hot = make_plan(n, 8 * 4, budget_bytes=llc).hot_size
    real_idx = torch.as_tensor(real_graph.indices).to(dev)
    real_n = real_graph.num_nodes
    # PageRank's gather takes ops.hot_gather's default hot region, min(N, 2^20)
    cases = {
        "quickstart": [
            ("quickstart pagerank (N,) f32",
             torch.as_tensor(rng.random((n, 1)), dtype=torch.float32), min(n, 1 << 20), qs_idx),
            ("quickstart step 5 (N,8) f32",
             torch.as_tensor(rng.random((n, 8)), dtype=torch.float32), qs_hot, qs_idx),
        ],
        "real-size pagerank": [
            ("real-size pagerank (N,) f32",
             torch.as_tensor(rng.random((real_n, 1)), dtype=torch.float32),
             min(real_n, 1 << 20), real_idx),
        ],
        # the other row layouts, and index views off 16-byte alignment
        None: [
            (f"(N,{d}) {str(dt)[6:]}", torch.as_tensor(rng.standard_normal((n, d)), dtype=dt),
             n // 4, qs_idx)
            for d, dt in ((130, torch.bfloat16), (1, torch.bfloat16), (3, torch.float32),
                          (64, torch.float32), (64, torch.bfloat16))
        ] + [
            ("quickstart (N,) f32, idx[1:]",
             torch.as_tensor(rng.random((n, 1)), dtype=torch.float32), n // 4, qs_idx[1:]),
            ("real-size (N,) f32, idx[1:]",
             torch.as_tensor(rng.random((real_n, 1)), dtype=torch.float32),
             min(real_n, 1 << 20), real_idx[1:]),
        ],
    }
    mixes, errs = {}, {}
    for path, path_cases in cases.items():
        errs[path] = 0.0
        for label, prop, h, idx in path_cases:
            prop = prop.to(dev)
            hot = prop[:h].contiguous()
            out = hot_gather_hot_part(hot, idx)
            plain = ref.hot_gather_ref(hot, idx)
            torch.cuda.synchronize()
            errs[path] = max(errs[path], float((out.float() - plain.float()).abs().max()))
            if not torch.equal(out, plain):
                fail(f"K1 {label}: differs from its plain version")
            # the two-tier mode over the whole table, on the stream with
            # negative and >= N indices mixed in, without and with cold ranks
            mixed = idx.clone()
            mixed[::101] = -1
            mixed[::211] = prop.shape[0] + 7
            if idx.data_ptr() % 16:  # keep the view off 16-byte alignment
                mixed = torch.cat([mixed[:1], mixed])[1:]
            rank = torch.cumsum(mixed >= h, 0, dtype=torch.int32)
            cap = int(rank[-1]) // 2
            for r, c in ((None, 0), (rank, cap)):
                two = hot_gather_two_tier(prop, mixed, h, r, c)
                two_plain = ref.hot_gather_two_tier_ref(prop, mixed, h, r, c)
                torch.cuda.synchronize()
                if not same_bits(two, two_plain):
                    fail(f"K1 two-tier {label} (cold capacity {c if r is not None else 'E'}): "
                         f"differs from its plain version")
                diff = (two.float() - two_plain.float()).nan_to_num(nan=0.0)
                errs[path] = max(errs[path], float(diff.abs().max()))
            print(f"K1 {label}: H={h} d={hot.shape[1]} E={idx.shape[0]} bit-identical; "
                  f"two-tier over N={prop.shape[0]} bit-identical, and with cold capacity "
                  f"{cap} of {int(rank[-1])}")
            if path is not None:
                mixes.setdefault(path, []).append((prop, h, idx))

    # the two-tier route makes no host sync, with and without a capacity
    real_prop = mixes["real-size pagerank"][0][0]
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.hot_gather(real_prop, real_idx)
        ops.hot_gather(real_prop, real_idx, cold_capacity=real_idx.shape[0] // 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("ops.hot_gather at real size: no host sync (sync debug mode 'error'), with the "
          "default capacity and with E/100")

    # semantics probed on the JAX package: -1 -> zeros, >= N -> NaN,
    # cold past cold_capacity -> zeros; (N,) props give (E,)
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([-1, 0, 1, 2, 5, 6, 3, 7], dtype=torch.int32)
    nan = float("nan")
    expect = {
        None: [[0, 0], [0, 1], [2, 3], [4, 5], [10, 11], [nan, nan], [6, 7], [nan, nan]],
        1: [[0, 0], [0, 1], [2, 3], [4, 5], [0, 0], [0, 0], [0, 0], [0, 0]],
    }
    for cap, rows in expect.items():
        want = torch.tensor(rows, dtype=torch.float32)
        got = ops.hot_gather(table.to(dev), idx.to(dev), hot_size=2, cold_capacity=cap).cpu()
        if not same_bits(got, want):
            fail(f"K1 semantics, cold_capacity={cap}: {got.tolist()}")
        got1 = ops.hot_gather(table[:, 1].contiguous().to(dev), idx.to(dev), hot_size=2,
                              cold_capacity=cap).cpu()
        if got1.shape != (8,) or not same_bits(got1, want[:, 1]):
            fail(f"K1 1-D semantics, cold_capacity={cap}: {got1.tolist()}")
    print("K1 semantics (-1, >= N, cold overflow, 1-D): as the JAX package")
    return mixes, errs


def k1_numbers(path: str, mix: list, counts: list[int], err: float, two_tier: bool) -> dict:
    """K1's numbers on one path: per-launch times and bound, each the mean
    over the path's launches, which run ``counts[i]`` times at ``mix[i]``.

    ``two_tier``: the path runs ``ops.hot_gather``, one launch of K1's
    two-tier mode over the whole table, so ``ms``, ``device_ms``,
    ``host_us``, ``plain_ms`` and ``bound_ms`` are that mode's, against
    ``hot_gather_two_tier_ref``; the hot-part mode's times and bound on
    the same launches stay beside them as ``hot_part_*``. Otherwise the
    path runs the hot-part mode, and those keys are its."""
    import torch

    from repro_torch.kernels.hot_gather import ops, ref
    from repro_torch.kernels.hot_gather.hot_gather import (
        hot_gather_hot_part,
        hot_gather_two_tier,
    )

    total = sum(counts)
    keys = ["ms", "device_ms", "host_us", "plain_ms", "library_ms", "library_device_ms",
            "library_host_us", "op_ms", "op_device_ms", "op_host_us"]
    if two_tier:
        keys += ["hot_part_ms", "hot_part_device_ms"]
    parts = {key: [] for key in keys}
    hot_bytes = all_bytes = 0.0
    shapes = []
    for (prop, h, idx), k in zip(mix, counts):
        hot, w = prop[:h].contiguous(), k / total
        lib_idx = idx.clamp(min=0)  # the library gather takes no -1 (cache misses)
        e, n, d, s = idx.shape[0], prop.shape[0], prop.shape[1], prop.element_size()
        hits = idx[(idx >= 0) & (idx < h)]
        rows = idx[(idx >= 0) & (idx < n)]
        hot_bytes += w * (e * 4 + e * d * s + torch.unique(hits).numel() * d * s)
        all_bytes += w * (e * 4 + e * d * s + torch.unique(rows).numel() * d * s)
        fns = {"library_": lambda: torch.index_select(prop, 0, lib_idx),
               "op_": lambda: ops.hot_gather(prop, idx, hot_size=h)}
        if two_tier:
            fns[""] = lambda: hot_gather_two_tier(prop, idx, h)
            fns["hot_part_"] = lambda: hot_gather_hot_part(hot, idx)
            plain = lambda: ref.hot_gather_two_tier_ref(prop, idx, h)  # noqa: E731
        else:
            fns[""] = lambda: hot_gather_hot_part(hot, idx)
            plain = lambda: ref.hot_gather_ref(hot, idx)  # noqa: E731
        for pre, fn in fns.items():
            dev_ms = device_ms(fn)
            parts[f"{pre}ms"].append(w * time_ms(fn))
            parts[f"{pre}device_ms"].append(None if dev_ms is None else w * dev_ms)
            if f"{pre}host_us" in parts:
                parts[f"{pre}host_us"].append(w * host_us(fn))
        parts["plain_ms"].append(w * time_ms(plain))
        shapes.append(f"{k} x hot ({h}, {d}) of N={n} {str(prop.dtype)[6:]}, "
                      f"E={e}, {hits.numel() / e:.4f} of edges hot")
    res = {key: None if None in vals else sum(vals) for key, vals in parts.items()}
    res["mode"] = "two-tier" if two_tier else "hot part"
    res["bound_ms"], res["bound_by"] = bound(all_bytes if two_tier else hot_bytes)
    res["op_bound_ms"] = bound(all_bytes)[0]
    if two_tier:
        res["hot_part_bound_ms"] = bound(hot_bytes)[0]
    res.update(max_abs_err=err, launches=total, shape="; ".join(shapes))

    hot_part = (f", hot-part mode {res['hot_part_ms']:.4f} ms (device "
                f"{fmt_ms(res['hot_part_device_ms'])}, bound {res['hot_part_bound_ms']:.4f} ms)"
                if two_tier else "")
    print(f"K1 timing on {path} ({res['shape']}), per launch: {res['mode']} mode "
          f"{res['ms']:.4f} ms (device {fmt_ms(res['device_ms'])}, host {res['host_us']:.2f} "
          f"us/call), plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms{hot_part}; "
          f"index_select of the full table {res['library_ms']:.4f} ms (device "
          f"{fmt_ms(res['library_device_ms'])}, host {res['library_host_us']:.2f} us/call); "
          f"ops.hot_gather {res['op_ms']:.4f} ms (device {fmt_ms(res['op_device_ms'])}, host "
          f"{res['op_host_us']:.2f} us/call, bound {res['op_bound_ms']:.4f} ms)")
    return res


def timed(prefix: str, fn, reps: int = 20, calls: int = 200) -> dict:
    """``{prefix}ms`` (CUDA events), ``{prefix}device_ms`` (torch.profiler)
    and ``{prefix}host_us`` (host microseconds per call) of ``fn``."""
    return {f"{prefix}ms": time_ms(fn, reps), f"{prefix}device_ms": device_ms(fn, reps),
            f"{prefix}host_us": host_us(fn, calls)}


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def check_k2(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.apps.engine import edge_map_pull
    from repro_torch.graph import generate
    from repro_torch.kernels.hot_gather import ops, ref
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_segment_sum

    tile_e, spt, d = 2048, 256, 8
    g = generate.uniform(20, 6, seed=0)
    idx_np, seg_np, n_pad = ops.build_aligned_edges(g.indptr, g.indices, spt, tile_e)
    if idx_np.shape[0] // tile_e * spt != n_pad:
        fail("K2: the uniform graph's layout spills tiles (the reference would reject it)")
    # the same edges with each tile shuffled within itself: any order gives the sum
    rng = np.random.default_rng(1)
    tiles = idx_np.shape[0] // tile_e
    perm = (np.arange(tiles)[:, None] * tile_e
            + rng.random((tiles, tile_e)).argsort(axis=1)).reshape(-1)
    layouts = {"sorted": (idx_np, seg_np), "shuffled": (idx_np[perm], seg_np[perm])}
    layouts = {k: (torch.as_tensor(i).to(dev), torch.as_tensor(s).to(dev))
               for k, (i, s) in layouts.items()}
    idx, seg = layouts["sorted"]
    prop = torch.as_tensor(rng.standard_normal((g.num_nodes, d)), dtype=torch.float32).to(dev)
    err = 0.0
    for label, hot in (("f32 all hot", prop), ("bf16 hot half", prop[: g.num_nodes // 2]
                                                 .to(torch.bfloat16).contiguous())):
        for order, (o_idx, o_seg) in layouts.items():
            out = hot_gather_segment_sum(hot, o_idx, o_seg, n_pad, tile_e, spt)
            again = hot_gather_segment_sum(hot, o_idx, o_seg, n_pad, tile_e, spt)
            plain = ref.gather_segment_sum_ref(hot, o_idx, o_seg, n_pad, tile_e, spt)
            torch.cuda.synchronize()
            if not torch.allclose(out, plain, rtol=1e-5, atol=1e-5):
                fail(f"K2 {label}, {order} tiles: differs from its plain version")
            if not torch.equal(out, again):
                fail(f"K2 {label}, {order} tiles: two launches differ")
            err = max(err, float((out - plain).abs().max()))
            print(f"K2 {label}, {order} tiles: {n_pad} segments, {tiles} tiles, max abs err "
                  f"{err:.3e}, two launches bit-identical")

    # K2's own path: the aligned pull sum, held against the engine's pull
    dg = g.device(dev)
    hot_gather_segment_sum.launches = 0
    fused = ops.hot_gather_segsum_aligned(prop, idx, seg, n_pad, spt, tile_e=tile_e)
    launches = hot_gather_segment_sum.launches
    pulled = edge_map_pull(dg, prop, gather_impl="plain")
    if not torch.allclose(fused[: g.num_nodes], pulled, rtol=1e-5, atol=1e-5):
        fail("K2 path: the aligned pull sum differs from edge_map_pull")
    if launches < 1:
        fail("K2 path: the aligned pull sum did not launch K2")
    print(f"K2 path (aligned pull sum) matches edge_map_pull, launches {launches}")

    hits = idx[idx >= 0]
    e = idx.shape[0]
    bound_ms, bound_by = bound(e * 8 + torch.unique(hits).numel() * d * 4 + n_pad * d * 4,
                               hits.numel() * d)
    adj = torch.sparse_coo_tensor(
        torch.stack([seg[idx >= 0].long(), hits.long()]),
        torch.ones(hits.numel(), device=dev), (n_pad, g.num_nodes)).coalesce().to_sparse_csr()
    s_idx, s_seg = layouts["shuffled"]
    res = dict(
        **timed("", lambda: hot_gather_segment_sum(prop, idx, seg, n_pad, tile_e, spt)),
        plain_ms=time_ms(lambda: ref.gather_segment_sum_ref(prop, idx, seg, n_pad, tile_e, spt)),
        **timed("library_", lambda: torch.sparse.mm(adj, prop)),
        shuffled_ms=time_ms(lambda: hot_gather_segment_sum(prop, s_idx, s_seg, n_pad, tile_e,
                                                           spt)),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, launches=launches,
        shape=f"uniform scale 20 degree 6, hot ({g.num_nodes}, {d}) f32, E={e} padded",
    )
    print(f"K2 timing at {res['shape']}: kernel {res['ms']:.4f} ms (device "
          f"{fmt_ms(res['device_ms'])}, host {res['host_us']:.2f} us/call), shuffled tiles "
          f"{res['shuffled_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, torch.sparse.mm "
          f"{res['library_ms']:.4f} ms (device {fmt_ms(res['library_device_ms'])}), bound "
          f"{bound_ms:.4f} ms")
    return res


def run_quickstart(dev) -> int:
    import numpy as np

    import quickstart_torch
    from repro_torch import apps
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part
    from repro_torch.kernels.segment_sum.segment_sum import segment_sum

    hot_gather_hot_part.launches = segment_sum.launches = 0
    out = quickstart_torch.main(str(dev))
    launches, ss_launches = hot_gather_hot_part.launches, segment_sum.launches
    r = out["results"]
    pr = out["pagerank"]
    print(f"quickstart: K1 launches {launches}, segment-sum launches {ss_launches}")
    if launches < 1:
        fail("quickstart: PageRank did not go through K1")
    # K1 once a PageRank iteration and once in step 5; the pull sum once an iteration
    if ss_launches != launches - 1:
        fail(f"quickstart: {ss_launches} segment-sum launches for {launches - 1} PageRank "
             f"iterations")
    if not (r["grasp"].misses < r["rrip"].misses < r["lru"].misses):
        fail("quickstart: GRASP < RRIP < LRU misses does not hold")
    if not r["opt"].misses < r["grasp"].misses:
        fail("quickstart: OPT < GRASP misses does not hold")
    if not out["speedup"] > 1.0:
        fail(f"quickstart: speed-up proxy {out['speedup']} <= 1")
    if out["gather_err"] != 0.0:
        fail(f"quickstart: hot_gather differs from index_select by {out['gather_err']}")
    g2 = dbg_graph("tw", 13)
    cpu = apps.pagerank(g2.device("cpu")).numpy()
    if pr.shape != (g2.num_nodes,) or not np.isfinite(pr).all() or abs(pr.sum() - 1) > 1e-3:
        fail("quickstart: PageRank is not a finite distribution of the expected shape")
    if not np.allclose(pr, cpu, rtol=1e-5, atol=1e-7):
        fail(f"quickstart: PageRank on the card differs from the CPU run by "
             f"{np.abs(pr - cpu).max():.3e}")
    print(f"quickstart: orderings hold, speed-up proxy {out['speedup']:.4f}, PageRank "
          f"matches the CPU run (max abs diff {np.abs(pr - cpu).max():.3e})")
    return launches


def run_real_pagerank(dev, g2) -> int:
    """PageRank at real size through K1 against the plain gather, in turns
    hot, plain, plain, hot, three times over. Returns K1's launches in one
    run through K1."""
    import statistics

    import torch

    from repro_torch import apps
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part
    from repro_torch.kernels.segment_sum.segment_sum import segment_sum

    base = torch.cuda.memory_allocated(dev)  # earlier phases' tensors, not counted
    dg = g2.device(dev)
    apps.pagerank(dg, tol=0.0, max_iters=1)  # warm-up of both routes
    apps.pagerank(dg, tol=0.0, max_iters=1, gather_impl="plain")
    runs = {"hot": [], "plain": []}
    launches = {"hot": set(), "plain": set()}
    ranks = {}
    for impl in ("hot", "plain", "plain", "hot") * 3:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        hot_gather_hot_part.launches = segment_sum.launches = 0
        t0 = time.perf_counter()
        ranks[impl] = apps.pagerank(dg, tol=0.0, max_iters=PR_ITERS, gather_impl=impl)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / PR_ITERS
        launches[impl].add(hot_gather_hot_part.launches)
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        runs[impl].append(ms)
        print(f"pagerank real size, {impl} gather: {ms:.4f} ms/iteration, peak device "
              f"memory of the graph and PageRank {peak:.3f} GiB, K1 launches "
              f"{hot_gather_hot_part.launches}, segment-sum launches {segment_sum.launches}")
        if segment_sum.launches != PR_ITERS:  # the pull sum, either gather
            fail(f"real-size PageRank, {impl} gather: {segment_sum.launches} segment-sum "
                 f"launches for {PR_ITERS} iterations")
    for impl, ms in runs.items():
        print(f"pagerank real size, {impl} gather over {len(ms)} runs: ms/iteration min "
              f"{min(ms):.4f} median {statistics.median(ms):.4f} max {max(ms):.4f}")
    if launches["plain"] != {0}:
        fail(f"real-size PageRank with the plain gather launched K1: {launches['plain']}")
    if len(launches["hot"]) != 1 or min(launches["hot"]) < 1:
        fail(f"real-size PageRank did not go through K1 once per run alike: {launches['hot']}")
    hot, plain = ranks["hot"], ranks["plain"]
    diff = float((hot - plain).abs().max())
    rel = float(((hot - plain).abs() / plain.abs().clamp(min=1e-30)).max())
    total = float(hot.sum())
    if not torch.isfinite(hot).all() or abs(total - 1) > 1e-3:
        fail(f"real-size PageRank is not a finite distribution (sum {total})")
    if diff > 1e-6 or rel > 1e-4:
        fail(f"real-size PageRank through K1 differs from the plain gather: abs {diff:.3e} "
             f"rel {rel:.3e}")
    print(f"pagerank real size: {g2.num_nodes} vertices, {g2.num_edges} edges, {PR_ITERS} "
          f"iterations; K1 vs plain gather max abs diff {diff:.3e}, max rel diff {rel:.3e}")
    return launches["hot"].pop()


def check_k3(dev, items) -> dict:
    """Phase 6: K3 in both modes against its plain versions, bit for bit,
    then its own path (ops.hot_bag) at serve_bulk with no host sync and
    against bag_ref. Returns K3's entry."""
    import numpy as np
    import torch

    from repro_torch.configs.base import RECSYS_SHAPES, get_arch
    from repro_torch.core.plan import default_budget_bytes, entries_for_budget
    from repro_torch.data.pipeline import zipf_ids
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.kernels.embedding_bag.embedding_bag import (
        hot_bag_hot_part,
        hot_bag_two_tier,
    )

    cfg = get_arch("mind")
    rng = np.random.default_rng(2)
    hot_size = entries_for_budget(default_budget_bytes(), cfg.embed_dim * 4,
                                  max_entries=cfg.n_items)
    print(f"K3 hot prefix: {hot_size} rows of d={cfg.embed_dim} f32 (L2 "
          f"{default_budget_bytes()} bytes)")
    cases = []  # (label, whole table, hot rows, ids, mask)
    for v, d, b, h, hot in [(2000, 16, 512, 8, 256), (5000, 64, 300, 12, 512),
                            (1000, 100, 64, 4, 1000)]:   # tests/test_kernels.py sweep
        table = torch.as_tensor(rng.standard_normal((v, d)), dtype=torch.float32).to(dev)
        ids = rng.integers(0, v, (b, h))
        ids = np.where(rng.random((b, h)) < 0.8, ids % hot, ids).astype(np.int32)
        mask = rng.random((b, h)) < 0.9
        cases.append((f"sweep V={v} d={d} B={b} H={h} hot={hot}", table, hot,
                      torch.as_tensor(ids).to(dev), torch.as_tensor(mask).to(dev)))
        if v == 2000:
            cases.append(("all masked", table, hot, cases[-1][3],
                          torch.zeros_like(cases[-1][4])))
            cases.append(("sweep V=2000 bf16", table.to(torch.bfloat16), hot, cases[-2][3],
                          cases[-2][4]))
    for name in ("serve_p99", "serve_bulk"):
        # Zipf-1.1 histories with a 0.9 keep mask, as recsys_batch draws them
        shape = (RECSYS_SHAPES[name].batch, cfg.hist_len)
        ids = torch.as_tensor(zipf_ids(rng, shape, cfg.n_items, a=1.1)).to(dev)
        mask = torch.as_tensor(rng.random(shape) < 0.9).to(dev)
        cases.append((f"MIND {name}", items, hot_size, ids, mask))
    err = 0.0
    for label, table, hot_rows, ids, mask in cases:
        hot = table[:hot_rows]
        out = hot_bag_hot_part(hot, ids, mask)
        plain = ref.hot_bag_ref(hot, ids, mask)
        torch.cuda.synchronize()
        if not same_bits(out, plain):
            fail(f"K3 {label}: differs from its plain version")
        if label == "all masked" and float(out.abs().max()) != 0.0:
            fail("K3 all masked: not exact zeros")
        err = max(err, float((out - plain).abs().max()))
        # the two-tier mode over the whole table, with negative and >= V ids
        # mixed in, without and with cold ranks (half the cold pairs kept)
        mixed = ids.clone()
        mixed[::7, 0] = -1
        mixed[1::11, -1] = table.shape[0] + 5
        mixed_mask = mask.clone()
        mixed_mask[1::11, -1] = True
        rank = torch.cumsum((mixed_mask & (mixed >= hot_rows)).view(-1), 0,
                            dtype=torch.int32).view(mixed.shape)
        cap = int(rank[-1, -1]) // 2
        for r, c in ((None, 0), (rank, cap)):
            two = hot_bag_two_tier(table, mixed, mixed_mask, hot_rows, r, c)
            two_plain = ref.hot_bag_two_tier_ref(table, mixed, mixed_mask, hot_rows, r, c)
            torch.cuda.synchronize()
            if not same_bits(two, two_plain):
                fail(f"K3 two-tier {label} (cold capacity {c if r is not None else 'B*H'}): "
                     f"differs from its plain version")
            diff = (two - two_plain).nan_to_num(nan=0.0)
            err = max(err, float(diff.abs().max()))
        print(f"K3 {label}: B={ids.shape[0]} H={ids.shape[1]} d={table.shape[1]} "
              f"{str(table.dtype)[6:]} hot={hot_rows} bit-identical; two-tier over "
              f"V={table.shape[0]} bit-identical, and with cold capacity {cap} of "
              f"{int(rank[-1, -1])}")
    del two, two_plain, mixed, mixed_mask, rank

    # K3's own path: ops.hot_bag at serve_bulk (the last case), no host sync
    hot_bag_hot_part.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.hot_bag(items, ids, mask, hot_size=hot_size)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = hot_bag_hot_part.launches
    want = ref.bag_ref(items, ids, mask)
    path_err = float((got - want).abs().max())
    close = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    del want
    print(f"K3 path (ops.hot_bag at serve_bulk, sync debug mode 'error') vs bag_ref: max abs "
          f"err {path_err:.3e}, launches {launches}")
    if launches != 1:
        fail(f"K3 path: ops.hot_bag launched K3 {launches} times, not once")
    if not close:
        fail(f"K3 path: ops.hot_bag differs from bag_ref by {path_err:.3e}")

    hot = items[:hot_size]
    b, hlen = ids.shape
    v, d = items.shape
    hit = mask & (ids >= 0) & (ids < hot_size)
    live = mask & (ids >= 0) & (ids < v)
    n_cold = int((mask & (ids >= hot_size)).sum())
    hot_distinct, all_distinct = torch.unique(ids[hit]).numel(), torch.unique(ids[live]).numel()
    refs, all_refs = int(hit.sum()), int(live.sum())
    streams = b * hlen * 5 + b * d * 4  # ids and mask read once, the bags written once
    bound_ms, bound_by = bound(streams + all_distinct * d * 4, all_refs * d)
    hot_bound_ms = bound(streams + hot_distinct * d * 4, refs * d)[0]
    cap = n_cold // 2
    res = dict(
        mode="two-tier",
        **timed("", lambda: hot_bag_two_tier(items, ids, mask, hot_size)),
        plain_ms=time_ms(lambda: ref.hot_bag_two_tier_ref(items, ids, mask, hot_size),
                         reps=5, warmup=1),
        **timed("library_", lambda: torch.nn.functional.embedding_bag(
            ids.clamp(0, v - 1), items, mode="sum", per_sample_weights=mask.float())),
        **timed("hot_part_", lambda: hot_bag_hot_part(hot, ids, mask)),
        hot_part_library_ms=time_ms(lambda: torch.nn.functional.embedding_bag(
            ids.clamp(0, hot_size - 1), hot, mode="sum", per_sample_weights=hit.float())),
        **timed("op_", lambda: ops.hot_bag(items, ids, mask, hot_size=hot_size)),
        **timed("op_capped_", lambda: ops.hot_bag(items, ids, mask, hot_size=hot_size,
                                                  cold_capacity=cap)),
        bound_ms=bound_ms, bound_by=bound_by, hot_part_bound_ms=hot_bound_ms,
        op_bound_ms=bound_ms, max_abs_err=err, launches=launches,
        shape=f"serve_bulk: {b} bags x {hlen} of ({v}, {d}) f32, hot {hot_size} rows; "
              f"{refs} hot references to {hot_distinct} rows, {all_refs - refs} cold to "
              f"{all_distinct - hot_distinct} rows ({refs / (b * hlen):.4f} / "
              f"{(all_refs - refs) / (b * hlen):.4f} of positions); capped route: "
              f"{cap} of {n_cold} cold pairs",
    )
    print(f"K3 timing at {res['shape']}: two-tier {res['ms']:.4f} ms (device "
          f"{fmt_ms(res['device_ms'])}, host {res['host_us']:.2f} us/call), bound "
          f"{bound_ms:.4f} ms ({bound_by}), plain {res['plain_ms']:.4f} ms, embedding_bag of "
          f"the whole table {res['library_ms']:.4f} ms (device "
          f"{fmt_ms(res['library_device_ms'])}); hot part {res['hot_part_ms']:.4f} ms (device "
          f"{fmt_ms(res['hot_part_device_ms'])}, host {res['hot_part_host_us']:.2f} us/call), "
          f"bound {hot_bound_ms:.4f} ms, embedding_bag of the hot prefix "
          f"{res['hot_part_library_ms']:.4f} ms; ops.hot_bag {res['op_ms']:.4f} ms (device "
          f"{fmt_ms(res['op_device_ms'])}, host {res['op_host_us']:.2f} us/call), with a "
          f"capacity {res['op_capped_ms']:.4f} ms (device {fmt_ms(res['op_capped_device_ms'])}"
          f"); row reads {all_refs * d * 4 / 1e9:.3f} GB")
    return res


def check_k1_exact(label: str, hot, idx) -> float:
    """K1 against its plain version, bit for bit, at one launch's shapes."""
    import torch

    from repro_torch.kernels.hot_gather import ref
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part

    out = hot_gather_hot_part(hot, idx)
    plain = ref.hot_gather_ref(hot, idx)
    torch.cuda.synchronize()
    if not torch.equal(out, plain):
        fail(f"K1 {label}: differs from its plain version")
    print(f"K1 {label}: H={hot.shape[0]} d={hot.shape[1]} E={idx.shape[0]} bit-identical")
    return float((out - plain).abs().max())


def check_mind_dense(dev, params) -> tuple[list, int, float]:
    """Phase 7: serve_scores through K1 against the plain route at
    serve_p99; retrieval_scores at retrieval_cand against the CPU. Returns
    K1's launch mix on the serve_scores path, its launches and its error."""
    import numpy as np
    import torch

    from repro_torch.configs.base import RECSYS_SHAPES, get_arch
    from repro_torch.core.plan import default_budget_bytes, entries_for_budget
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part
    from repro_torch.nn import recsys

    cfg = get_arch("mind")
    batch = recsys_batch(np.random.default_rng(3), cfg, RECSYS_SHAPES["serve_p99"])
    plain = recsys.serve_scores(params, cfg, batch, impl="plain")
    hot_gather_hot_part.launches = 0
    hot = recsys.serve_scores(params, cfg, batch, impl="hot")
    torch.cuda.synchronize()
    launches = hot_gather_hot_part.launches
    diff = float((hot - plain).abs().max())
    print(f"MIND serve_scores at serve_p99 {tuple(hot.shape)}: hot route vs plain max abs "
          f"diff {diff:.3e}, K1 launches {launches}")
    want_shape = (RECSYS_SHAPES["serve_p99"].batch, batch["candidates"].shape[1])
    if hot.shape != want_shape or not torch.isfinite(hot).all():
        fail(f"MIND serve_scores: not finite scores of shape {want_shape}")
    if not torch.allclose(hot, plain, rtol=1e-5, atol=1e-5):
        fail(f"MIND serve_scores: the K1 route differs from the plain route by {diff:.3e}")
    if launches < 1:
        fail("MIND serve_scores: the hot route did not launch K1")
    h = entries_for_budget(default_budget_bytes(), cfg.embed_dim * 4, max_entries=cfg.n_items)
    idx = torch.as_tensor(batch["hist"].reshape(-1)).to(dev)
    err = check_k1_exact("mind serve_scores hot", params["items"][:h], idx)

    # retrieval: one query against 1M uniform candidates, a 2^18-row hot split
    split = recsys.init(torch.Generator().manual_seed(1), cfg, hot_rows=RETRIEVAL_HOT_ROWS,
                        device="cpu")
    rb = recsys_batch(np.random.default_rng(4), cfg, RECSYS_SHAPES["retrieval_cand"])
    on_cpu = recsys.retrieval_scores(split, cfg, rb)
    on_card = recsys.retrieval_scores(recsys.to_device(split, dev), cfg, rb).cpu()
    n = rb["candidates"].shape[0]
    cold = int((rb["candidates"] >= RETRIEVAL_HOT_ROWS).sum())
    cap = max(int(n * recsys.COLD_FRACTION) // 256 * 256, 256)
    rdiff = float((on_card - on_cpu).abs().max())
    print(f"MIND retrieval_scores at retrieval_cand {tuple(on_card.shape)}: {cold} cold "
          f"candidates, cap {cap}, {max(cold - cap, 0)} zero rows; card vs CPU max abs diff "
          f"{rdiff:.3e}")
    if on_card.shape != (1, n) or not torch.isfinite(on_card).all():
        fail("MIND retrieval_scores: not finite scores of the expected shape")
    if not torch.allclose(on_card, on_cpu, rtol=1e-5, atol=1e-5):
        fail(f"MIND retrieval_scores: the card differs from the CPU by {rdiff:.3e}")
    return [(params["items"], h, idx)], launches, err


class StreamProbe:
    """Records, for the recsys engines of one run, each cache lookup (host
    ms, the calling thread's CPU ms, whether it had hot references, its
    ids) and each forward (ms, and its payloads and scores in
    ``batches``). Lookups end in a synchronisation, so the forward's
    remainder is the routed math."""

    def __init__(self):
        self.lookup_ms, self.forward_ms, self.lookups, self.batches = [], [], [], []
        self.lookup_cpu_ms = []

    @property
    def first(self):
        return self.batches[0]

    def __enter__(self):
        import numpy as np
        import torch

        from repro_torch.serve.cache import EmbeddingCache
        from repro_torch.serve.engine import RecsysServeEngine

        self._saved = EmbeddingCache.lookup, RecsysServeEngine.forward
        lookup, forward = self._saved
        probe = self

        def timed_lookup(cache, ids):
            t0, c0 = time.perf_counter(), time.thread_time()
            out, stats = lookup(cache, ids)
            torch.cuda.synchronize()
            probe.lookup_ms.append((time.perf_counter() - t0) * 1e3)
            probe.lookup_cpu_ms.append((time.thread_time() - c0) * 1e3)
            probe.lookups.append((np.asarray(ids), stats.hot_hits > 0))
            return out, stats

        def timed_forward(engine, payloads):
            t0 = time.perf_counter()
            out = forward(engine, payloads)
            probe.forward_ms.append((time.perf_counter() - t0) * 1e3)
            probe.batches.append((payloads, out))
            return out

        EmbeddingCache.lookup, RecsysServeEngine.forward = timed_lookup, timed_forward
        return self

    def __exit__(self, *exc):
        from repro_torch.serve.cache import EmbeddingCache
        from repro_torch.serve.engine import RecsysServeEngine

        EmbeddingCache.lookup, RecsysServeEngine.forward = self._saved


def run_mind_stream(dev, params) -> tuple[list, list, float]:
    """Phase 8: MIND through the GRASP cache at full width. Returns K1's
    launch mix on the cache path (one batch's history and candidate
    lookups), the launches of each and K1's error there."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part
    from repro_torch.nn import recsys
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import StreamConfig, run_recsys_stream
    from repro_torch.serve.scheduler import SchedulerConfig

    cfg = get_arch("mind")
    sched = SchedulerConfig(max_batch=MIND_MAX_BATCH, max_queue=MIND_REQUESTS)
    # every request arrives at t = 0, so every batch is full
    stream = StreamConfig(requests=MIND_REQUESTS, qps=float("inf"), candidates=64, zipf_a=1.1,
                          deadline_s=None, seed=0)
    budget = MIND_CACHE_BYTES
    runs = {}
    for label, frac, policy in (("grasp", 0.5, "rrpv"), ("unpinned rrpv", 0.0, "rrpv"),
                                ("unpinned lru", 0.0, "lru")):
        with StreamProbe() as probe:
            hot_gather_hot_part.launches = 0
            t0 = time.perf_counter()
            snap = run_recsys_stream(cfg, CacheConfig(budget, frac, policy), sched, stream,
                                     params=params, service_time_s=1e-3, device=dev)
            launches = hot_gather_hot_part.launches
        c = snap["counters"]
        runs[label] = (snap, probe, launches)
        print(f"MIND stream {label}: hot {snap['config']['hot_size']} cold "
              f"{snap['config']['cold_slots']} rows; hit rate {snap['hit_rate']:.6f} (hot "
              f"{c.get('hot_hits', 0)} cold {c.get('cold_hits', 0)} misses {c['misses']}); "
              f"{c['completed']} completed in {c['batches']} batches; K1 launches {launches}; "
              f"{time.perf_counter() - t0:.1f} s")
        if c["completed"] != stream.requests:
            fail(f"MIND stream {label}: {c['completed']} of {stream.requests} completed")
    grasp, probe, launches = runs["grasp"]
    for label in ("unpinned rrpv", "unpinned lru"):
        if not grasp["hit_rate"] > runs[label][0]["hit_rate"]:
            fail(f"MIND stream: GRASP's hit rate {grasp['hit_rate']} does not beat {label}'s "
                 f"{runs[label][0]['hit_rate']}")
        if runs[label][2] != 0:
            fail(f"MIND stream {label}: K1 launched {runs[label][2]} times with nothing pinned")
    hot_lookups = sum(hit for _, hit in probe.lookups)
    if launches < hot_lookups or hot_lookups < 1:
        fail(f"MIND stream grasp: {launches} K1 launches for {hot_lookups} lookups with hot "
             f"references")

    # the first batch against the dense forward of the same requests
    payloads, scores = probe.first
    batch = {k: np.stack([p[k] for p in payloads]) for k in payloads[0]}
    dense = recsys.serve_scores(params, cfg, batch, impl="plain").cpu().numpy()
    diff = float(np.abs(scores - dense).max())
    print(f"MIND stream grasp: first batch of {len(payloads)} scores {scores.shape} vs the "
          f"dense serve_scores max abs diff {diff:.3e}")
    if scores.shape != (MIND_MAX_BATCH, 64) or not np.isfinite(scores).all():
        fail(f"MIND stream: the first batch's scores are not finite ({MIND_MAX_BATCH}, 64)")
    if not np.allclose(scores, dense, rtol=1e-5, atol=1e-5):
        fail(f"MIND stream: the cache-fed scores differ from the dense forward by {diff:.3e}")

    # K1's shapes on this path: the first batch's history and candidate lookups
    hot_size = grasp["config"]["hot_size"]
    items = params["items"]
    mix, counts, err = [], [], 0.0
    for k, kind in enumerate(("history", "candidates")):
        ids = probe.lookups[k][0]
        idx = torch.as_tensor(np.where(ids < hot_size, ids, -1).astype(np.int32)).to(dev)
        err = max(err, check_k1_exact(f"mind serve cache {kind}", items[:hot_size], idx))
        mix.append((items, hot_size, idx))
        counts.append(sum(hit for _, hit in probe.lookups[k::2]))

    # measured service time: throughput, tails, and where a batch's time goes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with StreamProbe() as probe:
        snap = run_recsys_stream(cfg, CacheConfig(budget, 0.5, "rrpv"), sched, stream,
                                 params=params, device=dev)
    peak = torch.cuda.max_memory_allocated(dev)
    e2e = snap["latency"]["e2e"]
    lookup = [a + b for a, b in zip(probe.lookup_ms[::2], probe.lookup_ms[1::2])]
    routed = [f - lk for f, lk in zip(probe.forward_ms, lookup)]
    busy_s = sum(probe.forward_ms) / 1e3
    print(f"MIND stream measured: {snap['counters']['completed']} requests in "
          f"{snap['counters']['batches']} batches, {snap['counters']['completed'] / busy_s:.1f} "
          f"requests/s; e2e p50 {e2e['p50_s'] * 1e3:.3f} ms p99 {e2e['p99_s'] * 1e3:.3f} ms "
          f"max {e2e['max_s'] * 1e3:.3f} ms; per batch: cache lookups (host, both) median "
          f"{statistics.median(lookup):.3f} ms, routed forward (card) median "
          f"{statistics.median(routed):.3f} ms, forward total median "
          f"{statistics.median(probe.forward_ms):.3f} ms; hit rate {snap['hit_rate']:.6f}; "
          f"peak device memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
          f"the parameters)")
    return mix, counts, err


class GNNProbe:
    """Records, for GNNServeEngine runs, each batch's host ms of sampling
    and its count of pad references (masked nodes, id 0), host ms of the
    cache lookup (ending in a synchronisation) with whether it had hot
    references, and device ms of the forward (CUDA events around
    ``nn.gnn.apply``, read by ``forward_ms`` once the run has ended)."""

    def __init__(self):
        self.sample_ms, self.pad_refs, self.lookup_ms, self.hot_lookups = [], [], [], []
        self._events = []

    def __enter__(self):
        import torch

        from repro_torch.graph import sampler
        from repro_torch.nn import gnn
        from repro_torch.serve.cache import EmbeddingCache

        self._saved = sampler.sample_blocks, EmbeddingCache.lookup, gnn.apply
        sample, lookup, apply = self._saved
        probe = self

        def timed_sample(*args):
            t0 = time.perf_counter()
            out = sample(*args)
            probe.sample_ms.append((time.perf_counter() - t0) * 1e3)
            probe.pad_refs.append(int((~out.node_mask).sum()))
            return out

        def timed_lookup(cache, ids):
            t0 = time.perf_counter()
            out, stats = lookup(cache, ids)
            torch.cuda.synchronize()
            probe.lookup_ms.append((time.perf_counter() - t0) * 1e3)
            probe.hot_lookups.append(stats.hot_hits > 0)
            return out, stats

        def timed_apply(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = apply(*args)
            end.record()
            probe._events.append((start, end))
            return out

        sampler.sample_blocks, EmbeddingCache.lookup, gnn.apply = (timed_sample, timed_lookup,
                                                                   timed_apply)
        return self

    def __exit__(self, *exc):
        from repro_torch.graph import sampler
        from repro_torch.nn import gnn
        from repro_torch.serve.cache import EmbeddingCache

        sampler.sample_blocks, EmbeddingCache.lookup, gnn.apply = self._saved

    def forward_ms(self) -> list[float]:
        return [start.elapsed_time(end) for start, end in self._events]


def run_gnn_serving(dev, g2) -> tuple[list, list, float]:
    """Phase 10: GIN served through the GRASP feature cache over ``g2`` (the
    ``lj`` graph of phase 5). Returns K1's launch mix on the cache path (the
    check batch's lookup), the GRASP run's launches and K1's error there."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.graph import sampler
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part
    from repro_torch.nn import gnn
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import GNNServeEngine
    from repro_torch.serve.scheduler import SchedulerConfig

    n = g2.num_nodes
    print(f"GNN serving graph: the lj graph of phase 5 ({n} vertices, {g2.num_edges} edges) "
          f"stands in for ogb_products as the JAX package's gnn_full_graph_batch builds it: "
          f"rmat(ceil(log2 2,449,029) = 22, 61,859,140 // 2^22 = 14), scale 22 and edge factor "
          f"14, the shape of this graph")
    cfg = get_arch("gin-tu")
    t0 = time.perf_counter()
    feats = np.random.default_rng(0).standard_normal((n, GNN_D_FEAT), dtype=np.float32)
    params = gnn.init(torch.Generator().manual_seed(0), cfg, GNN_D_FEAT, device=dev)
    seeds = np.random.default_rng(1).integers(0, n, (GNN_REQUESTS, GNN_SEEDS_PER_REQ))
    print(f"GNN features {feats.shape} f32 ({feats.nbytes / 2**30:.3f} GiB on the host) and "
          f"{cfg.name} parameters ({cfg.n_layers} layers, d {cfg.d_hidden}, d_out {cfg.d_out}, "
          f"learnable eps) in {time.perf_counter() - t0:.1f} s")

    # the check batch: GIN over the densely gathered features, on the card
    # (this also warms the card's kernels) and on the CPU
    blocks = sampler.sample_blocks(g2, seeds[:GNN_MAX_BATCH].reshape(-1), GNN_FANOUT,
                                   np.random.default_rng(2))
    x = torch.where(torch.from_numpy(blocks.node_mask)[:, None],
                    torch.from_numpy(feats[blocks.node_ids]), 0.0)
    dense_batch = {"x": x, "src": blocks.src, "dst": blocks.dst, "emask": blocks.emask}
    local = torch.from_numpy(blocks.seeds_local).long()
    dense = gnn.apply(params, cfg, dict(dense_batch, x=x.to(dev)))[local.to(dev)].cpu()
    on_cpu = gnn.apply(gnn.to_device(params, torch.device("cpu")), cfg, dense_batch)[local]
    dev_batch = dict(dense_batch, x=x.to(dev))
    fwd = lambda: gnn.apply(params, cfg, dev_batch)  # noqa: E731
    print(f"GNN check batch: {blocks.n_sub} nodes ({int(blocks.node_mask.sum())} sampled, the "
          f"rest pads of node 0), {blocks.src.shape[0]} edges ({int(blocks.emask.sum())} valid), "
          f"lookup of {blocks.n_sub * GNN_D_FEAT * 4 / 1e6:.1f} MB of rows; GIN forward on the "
          f"card {time_ms(fwd, reps=10):.4f} ms (event), device busy "
          f"{fmt_ms(device_ms(fwd, reps=10))} (profiler), host {host_us(fwd, calls=50):.1f} "
          f"us/call")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    sched = SchedulerConfig(max_batch=GNN_MAX_BATCH, max_queue=GNN_REQUESTS)
    runs = {}
    for label, frac, policy in (("grasp", 0.5, "rrpv"), ("unpinned rrpv", 0.0, "rrpv"),
                                ("unpinned lru", 0.0, "lru")):
        eng = GNNServeEngine(params, cfg, g2, feats, CacheConfig(GNN_CACHE_BYTES, frac, policy),
                             sched, fanout=GNN_FANOUT, seeds_per_req=GNN_SEEDS_PER_REQ, seed=0,
                             device=dev)
        with GNNProbe() as probe:
            hot_gather_hot_part.launches = 0
            t0 = time.perf_counter()
            reqs = [eng.submit({"seeds": s}) for s in seeds]
            eng.run_until_idle()
            wall = time.perf_counter() - t0
            launches = hot_gather_hot_part.launches
        snap = eng.metrics.snapshot()
        c, e2e = snap["counters"], snap["latency"]["e2e"]
        done = sum(r.status == "done" for r in reqs)
        fwd = probe.forward_ms()
        hits, pads = c.get("hot_hits", 0) + c.get("cold_hits", 0), sum(probe.pad_refs)
        refs = hits + c["misses"]
        print(f"GNN serving {label}: pinned {eng.cache.hot_size} rows, cold {eng.cache.cold_slots} "
              f"rows; {done} of {GNN_REQUESTS} requests in {c['batches']} batches, "
              f"{done / wall:.1f} requests/s; e2e p50 {e2e['p50_s'] * 1e3:.3f} ms p99 "
              f"{e2e['p99_s'] * 1e3:.3f} ms; hit rate {snap['hit_rate']:.6f} (hot "
              f"{c.get('hot_hits', 0)} cold {c.get('cold_hits', 0)} misses {c['misses']}); pad "
              f"references {pads} of {refs}, hit rate over the others "
              f"{(hits - pads) / (refs - pads):.6f} (every pad counted a hit: all are but node "
              f"0's first fill in an unpinned cache); per "
              f"batch median: sampling (host) {statistics.median(probe.sample_ms):.3f} ms, cache "
              f"lookup (host) {statistics.median(probe.lookup_ms):.3f} ms, forward (device) "
              f"{statistics.median(fwd):.3f} ms (max {max(fwd):.3f}); K1 launches {launches}; "
              f"{wall:.1f} s")
        if done != GNN_REQUESTS or c["completed"] != GNN_REQUESTS:
            fail(f"GNN serving {label}: {done} of {GNN_REQUESTS} requests completed")
        for r in reqs:
            if r.result.shape != (GNN_SEEDS_PER_REQ, cfg.d_out) or not np.isfinite(r.result).all():
                fail(f"GNN serving {label}: a result is not finite {(GNN_SEEDS_PER_REQ, cfg.d_out)}")
        runs[label] = (eng if label == "grasp" else None, probe, launches, snap)
        del eng
    eng, probe, launches, snap = runs["grasp"]
    batches = snap["counters"]["batches"]
    if launches < batches or launches < sum(probe.hot_lookups):
        fail(f"GNN serving grasp: {launches} K1 launches for {batches} batches")
    for label in ("unpinned rrpv", "unpinned lru"):
        if runs[label][2] != 0:
            fail(f"GNN serving {label}: K1 launched {runs[label][2]} times with nothing pinned")
    print("GNN serving hit rates (no winner asserted): " + ", ".join(
        f"{k} {v[3]['hit_rate']:.6f}" for k, v in runs.items()))

    # the check batch through the GRASP engine's cache: K1, then the forward
    got = torch.from_numpy(eng.forward_blocks(blocks))
    if got.shape != (blocks.seeds_local.shape[0], cfg.d_out) or not torch.isfinite(got).all():
        fail("GNN serving: forward_blocks is not finite logits of the expected shape")
    diff = float((got - dense).abs().max())
    cpu_diff = float((got - on_cpu).abs().max())
    print(f"GNN forward_blocks {tuple(got.shape)}: vs GIN over the dense gather on the card max "
          f"abs diff {diff:.3e}; vs the port on the CPU {cpu_diff:.3e}")
    if not torch.allclose(got, dense, rtol=1e-5, atol=1e-6):
        fail(f"GNN serving: forward_blocks differs from the dense gather by {diff:.3e}")
    if not torch.allclose(got, on_cpu, rtol=1e-4, atol=1e-5):
        fail(f"GNN serving: the card differs from the CPU by {cpu_diff:.3e}")
    hot_size = eng.cache.hot_size
    ids = blocks.node_ids
    idx = torch.as_tensor(np.where(ids < hot_size, ids, -1).astype(np.int32)).to(dev)
    err = check_k1_exact("gnn serve cache", eng.cache._hot_block, idx)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"GNN serving: peak device memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} "
          f"GiB above the earlier phases' tensors)")
    table = torch.from_numpy(feats).to(dev)
    return [(table, hot_size, idx)], [launches], err


def same_outputs(label: str, got, want, rtol: float | None = None, atol: float = 0.0) -> str:
    """Fail unless ``got`` (on the card) equals ``want`` (on the CPU), or is
    within ``rtol``/``atol`` of it; returns a short account of the match."""
    import torch

    got = got.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{label}: {got.dtype} {tuple(got.shape)} on the card, {want.dtype} "
             f"{tuple(want.shape)} on the CPU")
    if rtol is None:
        if not torch.equal(got, want):
            fail(f"{label}: {int((got != want).sum())} entries differ from the CPU run")
        return "exact"
    diff = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{label}: differs from the CPU run by {diff:.3e} (rtol {rtol}, atol {atol})")
    return f"max abs diff {diff:.3e}"


def run_graph_suite(dev) -> None:
    """Phase 9 (a): examples/graph_suite_torch.main("tw", 13) on the card,
    each app's output against the same function on the CPU, K1's launches
    against the PR and PRD iterations; then PRD alone, once per iteration."""
    import torch

    import graph_suite_torch
    from repro_torch import apps
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part
    from repro_torch.kernels.segment_sum.segment_sum import segment_sum

    hot_gather_hot_part.launches = segment_sum.launches = 0
    out = graph_suite_torch.main("tw", 13, str(dev))
    launches, ss_launches = hot_gather_hot_part.launches, segment_sum.launches
    iters = out["iters"]
    want = sum(it["pr"] + it["prd"] for it in iters.values())
    print(f"graph suite: K1 launches {launches}, segment-sum launches {ss_launches}, PR + PRD "
          f"iterations {want}")
    if launches != want or ss_launches != want:
        fail(f"graph suite: {launches} K1 and {ss_launches} segment-sum launches for {want} PR "
             f"and PRD iterations")
    for label, g in out["graphs"].items():
        card = out["outputs"][label]
        cpu, _, cpu_iters = graph_suite_torch.run_apps(g, f"{label}, on the CPU", "cpu")
        # PR's and PRD's stopping tests read sums whose order differs
        if any(cpu_iters[k] != iters[label][k] for k in ("sssp", "bc", "radii")):
            fail(f"graph suite {label}: iterations {iters[label]} on the card, {cpu_iters} on "
                 f"the CPU")
        checks = {
            "pr": same_outputs(f"{label} PR", card["pr"], cpu["pr"], 1e-5, 1e-7),
            "prd": same_outputs(f"{label} PRD", card["prd"], cpu["prd"], 1e-4, 1e-7),
            "sssp": same_outputs(f"{label} SSSP", card["sssp"], cpu["sssp"]),
            "bc level": same_outputs(f"{label} BC level", card["bc"][2], cpu["bc"][2]),
            "bc sigma": same_outputs(f"{label} BC sigma", card["bc"][1], cpu["bc"][1]),
            "bc delta": same_outputs(f"{label} BC delta", card["bc"][0], cpu["bc"][0], 1e-4),
            "radii": same_outputs(f"{label} Radii radii", card["radii"][0], cpu["radii"][0]),
            "radii mask": same_outputs(f"{label} Radii mask", card["radii"][1],
                                       cpu["radii"][1]),
        }
        for name, t in (("pr", card["pr"]), ("prd", card["prd"]), ("bc delta", card["bc"][0])):
            if not torch.isfinite(t).all():
                fail(f"graph suite {label}: {name} is not finite")
        print(f"graph suite {label}: card vs CPU " + "; ".join(
            f"{k} {v}" for k, v in checks.items()))

    dg = out["graphs"]["dbg"].device(dev)
    stats = {}
    hot_gather_hot_part.launches = segment_sum.launches = 0
    apps.pagerank_delta(dg, stats=stats)
    launches, ss_launches = hot_gather_hot_part.launches, segment_sum.launches
    print(f"graph suite: PRD alone, {stats['iters']} iterations, K1 launches {launches}, "
          f"segment-sum launches {ss_launches}")
    if launches != stats["iters"] or ss_launches != stats["iters"]:
        fail(f"PRD: {launches} K1 and {ss_launches} segment-sum launches for {stats['iters']} "
             f"iterations")


def run_policies(qs_graph) -> None:
    """Phase 9 (b): all 13 policies on the quickstart's PR trace (host). The
    hit accounting holds and OPT misses least; the other orders are printed,
    not judged."""
    from repro_torch.core import cachesim, policies
    from repro_torch.graph import datasets, traces

    llc = datasets.scaled_llc_bytes("tw", qs_graph, elem_bytes=16)
    tr, _ = traces.generate_trace(qs_graph, "pr", llc)
    res = {}
    for name in policies.POLICIES:
        r = cachesim.simulate(tr, name, llc)
        if (r.accesses != tr.length or int(r.accesses_by_hint.sum()) != tr.length
                or (r.hits_by_hint > r.accesses_by_hint).any()
                or int(r.hits_by_hint.sum()) != r.hits):
            fail(f"policy {name}: hit accounting {r.hits_by_hint} of {r.accesses_by_hint}")
        res[name] = r
    print(f"policies on the quickstart PR trace ({tr.length} accesses, LLC {llc} bytes), "
          f"misses: " + ", ".join(f"{k} {r.misses}" for k, r in res.items()))
    worse = [k for k, r in res.items() if r.misses < res["opt"].misses]
    if worse:
        fail(f"policies: {worse} miss less than OPT ({res['opt'].misses})")


def run_real_suite(dev, g2) -> tuple[int, dict]:
    """Phase 9 (c): PRD, SSSP, BC and Radii at real size on ``g2`` (the
    ``lj`` graph of phase 5). Returns K1's launches in one PRD run through
    K1, and the relaxation kernels' numbers (``relax_numbers``)."""
    import statistics

    import torch

    from repro_torch import apps
    from repro_torch.graph.csr import transpose
    from repro_torch.graph.generate import add_uniform_weights
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part
    from repro_torch.kernels.segment_min.relax import relax_min
    from repro_torch.kernels.segment_sum.segment_sum import segment_sum

    t0 = time.perf_counter()
    out_csr = transpose(add_uniform_weights(g2, seed=1))
    print(f"real-size suite: weighted out-CSR built on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)  # earlier phases' tensors, not counted
    dg = g2.device(dev)
    d_out = out_csr.device(dev)
    d_hops = dataclasses.replace(d_out, weights=None)  # the same edges, unit weights

    def run(label, fn, sssp=False, prd=False):
        """One app run; SSSP's must launch the relaxation once an iteration,
        PRD's pull the segment-sum kernel once an iteration; the others
        launch neither."""
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        hot_gather_hot_part.launches = relax_min.launches = segment_sum.launches = 0
        t0 = time.perf_counter()
        res = fn(stats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rx_launches, ss_launches = relax_min.launches, segment_sum.launches
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        print(f"real-size {label}: {ms:.3f} ms, {stats['iters']} iterations "
              f"({ms / max(stats['iters'], 1):.4f} ms each), peak device memory of the graphs "
              f"and the app {peak:.3f} GiB, K1 launches {hot_gather_hot_part.launches}, "
              f"relaxation launches {rx_launches}, segment-sum launches {ss_launches}")
        if rx_launches != (stats["iters"] if sssp else 0):
            fail(f"real-size {label}: {rx_launches} relaxation launches for "
                 f"{stats['iters']} iterations")
        if ss_launches != (stats["iters"] if prd else 0):
            fail(f"real-size {label}: {ss_launches} segment-sum launches for "
                 f"{stats['iters']} iterations")
        return res, stats, hot_gather_hot_part.launches, ms

    # PageRank-Delta through K1 against the plain gather, in turns
    for impl in ("hot", "plain"):  # warm-up of both routes
        apps.pagerank_delta(dg, max_iters=1, gather_impl=impl)
    ranks, prd_launches, prd_ms = {}, set(), {"hot": [], "plain": []}
    for impl in PRD_TURNS:
        ranks[impl], st, launches, ms = run(
            f"PRD, {impl} gather", lambda st: apps.pagerank_delta(dg, gather_impl=impl, stats=st),
            prd=True)
        it = st["iters"]
        prd_ms[impl].append(ms / it)
        if impl == "hot" and launches != it:
            fail(f"real-size PRD: {launches} K1 launches for {it} iterations")
        if impl == "plain" and launches:
            fail(f"real-size PRD with the plain gather launched K1 {launches} times")
        if impl == "hot":
            prd_launches.add(launches)
    for impl, ms in prd_ms.items():
        print(f"real-size PRD, {impl} gather over {len(ms)} runs: ms/iteration min "
              f"{min(ms):.4f} median {statistics.median(ms):.4f} max {max(ms):.4f}")
    hot, plain = ranks["hot"], ranks["plain"]
    rel = float(((hot - plain).abs() / plain.abs().clamp(min=1e-30)).max())
    if not torch.isfinite(hot).all() or rel > 1e-4:
        fail(f"real-size PRD through K1: finite {bool(torch.isfinite(hot).all())}, max rel "
             f"diff from the plain gather {rel:.3e}")
    print(f"real-size PRD: K1 vs plain gather max rel diff {rel:.3e}, ranks finite")

    # SSSP from 0: no edge relaxes any further
    dist = run("SSSP from 0", lambda st: apps.sssp(d_out, 0, stats=st), sssp=True)[0]
    src, dst = d_out.dst.long(), d_out.indices.long()
    d_src = dist[src]
    relaxes = int((torch.isfinite(d_src) & (dist[dst] > d_src + d_out.weights)).sum())
    reached = int(torch.isfinite(dist).sum())
    del d_src
    print(f"real-size SSSP: {reached} vertices reached, {relaxes} edges relax further")
    if float(dist[0]) != 0.0 or relaxes:
        fail(f"real-size SSSP: dist[0] = {float(dist[0])}, {relaxes} edges relax further")

    # BC from 0: levels are the hop distances within 64 hops
    hops = run("SSSP from 0, unit weights", lambda st: apps.sssp(d_hops, 0, stats=st),
               sssp=True)[0]
    _, sigma, level = run("BC from 0", lambda st: apps.bc_single_source(d_hops, 0, stats=st))[0]
    want = torch.where(hops <= 64, hops, torch.full_like(hops, -1.0)).to(torch.int32)
    reached_bc = level >= 0
    print(f"real-size BC: {int(reached_bc.sum())} vertices reached, deepest level "
          f"{int(level.max())}, largest sigma {float(sigma.max()):.4g}")
    if not torch.equal(level, want):
        fail(f"real-size BC: {int((level != want).sum())} levels differ from the hop distances")
    if not (sigma[reached_bc] >= 1).all():
        fail("real-size BC: sigma < 1 on a reached vertex")

    # Radii from roots 0..7: bit 0 is the BFS from vertex 0 again
    radii, mask = run("Radii from roots 0..7", lambda st: apps.radii_estimate(
        dg, torch.arange(8), stats=st))[0]
    bit0 = (mask.to(torch.int64) & 1) == 1
    print(f"real-size Radii: {int(bit0.sum())} vertices with bit 0, largest radius "
          f"{int(radii.max())}")
    if not torch.equal(bit0, reached_bc):
        fail(f"real-size Radii: bit 0 differs from BC's reach at "
             f"{int((bit0 != reached_bc).sum())} vertices")
    if not (radii[reached_bc] >= level[reached_bc]).all():
        fail("real-size Radii: a radius below its BFS level")
    if len(prd_launches) != 1:
        fail(f"real-size PRD: K1 launches differ between runs: {prd_launches}")
    del src, dst, hops, sigma, level, radii, mask, dist, dg, d_out, d_hops
    sm = relax_numbers(dev)
    return prd_launches.pop(), sm


def relax_numbers(dev) -> dict:
    """SSSP on the benchmark's kron graph at ``lj``'s scale, from the SSSP
    cells' first source, whose frontiers, as the cells', reach a large
    share of the edges: one run of ``apps.sssp`` (one relaxation an
    iteration), then a replay of its iterations through the relaxation
    wrapper that holds each iteration's distances and frontier bit for bit
    against the relaxation's plain version and its settling
    (``ref.relax_min_ref``, ``ref.settle_ref``) from the same state. The
    chain the port ran before it (``old_chain``: the gathers of ``dist``
    and ``active`` through int64 sources, the add, ``where`` and the
    segment-min kernel) must give the plain relaxation's minima, and its
    segment-min kernel ``ref.segment_min_ref``'s. Times, per launch and as
    the mean over the iterations, each relaxation from the iteration's own state
    (restored before each run): the wrapper (``ms`` by CUDA events,
    ``device_ms``, its kernels' time by torch.profiler; ``host_us`` of a
    launch over no active row), its plain version (``plain_ms``) and the
    old chain (``library_ms``, ``library_device_ms``). The bound reads the
    active rows' edges (8 B each: target and weight), their offsets (8 B a
    row) and 9 B a vertex (8·F + 8·A + 9N bytes). The replay must end where
    the app's run did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gbench import graphs, spec
    from gbench.apps import sssp as sssp_app
    from repro_torch import apps
    from repro_torch.graph.csr import DeviceCSR, out_degree_sum
    from repro_torch.kernels.segment_min import ref
    from repro_torch.kernels.segment_min.relax import relax_min
    from repro_torch.kernels.segment_min.segment_min import segment_min

    g = graphs.make({**spec.config(spec.benchmark(), "kron25"), "scale": REAL_SCALE},
                    2**31 + 11, dev, weighted=True)
    source = sssp_app.pick_sources(g, 1, spec.traffic("sssp")["source_seed"])[0]
    g_out = DeviceCSR(indptr=g.indptr, indices=g.indices, dst=g.dst, weights=g.weights,
                      num_nodes=g.num_nodes)
    stats = {}
    apps.sssp(g_out, source, max_iters=1)  # warm-up
    relax_min.launches = 0
    dist = apps.sssp(g_out, source, stats=stats)
    if relax_min.launches != stats["iters"]:
        fail(f"SSSP on kron {REAL_SCALE}: {relax_min.launches} relaxation launches for "
             f"{stats['iters']} iterations")
    n, e = g_out.num_nodes, g_out.indices.shape[0]
    src_of_edge, tgt, w = g_out.dst.long(), g_out.indices, g_out.weights
    reps = 5

    def messages(d, a):
        return torch.where(a[src_of_edge], d[src_of_edge] + w, float("inf"))

    def old_chain(d, a):
        best = segment_min(messages(d, a), tgt, n)
        return best < d, torch.minimum(d, best)

    def same(x, y):
        return torch.equal(x.view(torch.int32), y.view(torch.int32))

    def state():  # keys at +inf, the flag up, no edge counted
        return (torch.full((n,), float("inf"), device=dev).view(torch.int32),
                torch.ones(1, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev))

    keys, flag, relaxed = state()
    scratch = state()  # for the timed runs: each leaves its keys at +inf again

    parts = {key: [] for key in ("ms", "device_ms", "host_us", "plain_ms", "library_ms",
                                 "library_device_ms")}
    cur = torch.full((n,), float("inf"), device=dev)
    cur[source] = 0.0
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[source] = True
    d_t, a_t = torch.empty_like(cur), torch.empty_like(active)
    iters = edges = rows = 0
    while bool(flag):
        d0, a0 = cur.clone(), active.clone()
        best = ref.relax_min_ref(g_out.indptr, tgt, w, d0, a0)
        msgs = messages(d0, a0)
        chain_best = segment_min(msgs, tgt, n)
        if not (same(chain_best, ref.segment_min_ref(msgs, tgt, n)) and same(chain_best, best)):
            fail(f"SSSP on kron {REAL_SCALE}, iteration {iters}: the segment-min kernel "
                 f"differs from its plain version, or the gather, where and segment-min "
                 f"chain from the plain relaxation")
        want_dist, want_active = d0.clone(), a0.clone()
        ref.settle_ref(best, want_dist, want_active)
        del best, msgs, chain_best
        edges += int(out_degree_sum(g_out.indptr, a0))
        rows += int(a0.sum())
        relax_min(g_out.indptr, tgt, w, cur, active, keys, flag, relaxed)
        if not (torch.equal(active, want_active) and same(cur, want_dist)):
            fail(f"relaxation on kron {REAL_SCALE}, iteration {iters}: differs from its plain "
                 f"version and settling")
        total = 0.0
        for _ in range(reps):  # events around the relaxation alone
            d_t.copy_(d0)
            a_t.copy_(a0)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            relax_min(g_out.indptr, tgt, w, d_t, a_t, *scratch)
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        parts["ms"].append(total / reps)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            spin_pad()
            for _ in range(reps):
                d_t.copy_(d0)
                a_t.copy_(a0)
                relax_min(g_out.indptr, tgt, w, d_t, a_t, *scratch)
            spin_pad()
        ours = [ev for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and ("relax_" in ev.key or "settle_kernel" in ev.key)]
        busy = sum(ev.self_device_time_total for ev in ours)
        parts["device_ms"].append(busy / 1e3 / reps if busy > 0 else None)
        a_t.zero_()
        parts["host_us"].append(host_us(
            lambda: relax_min(g_out.indptr, tgt, w, d_t, a_t, *scratch), 200))
        parts["plain_ms"].append(time_ms(lambda: ref.relax_min_ref(g_out.indptr, tgt, w, d0, a0),
                                         reps))
        parts["library_ms"].append(time_ms(lambda: old_chain(d0, a0), reps))
        parts["library_device_ms"].append(device_ms(lambda: old_chain(d0, a0), reps))
        iters += 1
        del d0, a0, want_active, want_dist
    if (iters != stats["iters"] or not int(relaxed) == edges == stats["edges_relaxed"]
            or not same(cur, dist)):
        fail(f"relaxation replay on kron {REAL_SCALE}: {iters} iterations against the app's "
             f"{stats['iters']}, edges {int(relaxed)} / {edges} against "
             f"{stats['edges_relaxed']}, distances equal "
             f"{same(cur, dist)}")
    res = {key: None if None in vals else sum(vals) / iters for key, vals in parts.items()}
    res["bound_ms"], res["bound_by"] = bound((8 * edges + 8 * rows + 9 * n * iters) / iters)
    res.update(max_abs_err=0.0, launches=iters, frontier_share=edges / (e * iters),
               shape=f"{iters} x (out-CSR of E={e} int32 targets, float32 weights) into N={n}")
    print(f"relaxation timing on kron {REAL_SCALE} SSSP from {source} ({res['shape']}, "
          f"{res['frontier_share']:.4f} of edges out of active rows), per launch: "
          f"{res['ms']:.4f} ms (device {fmt_ms(res['device_ms'])}, host {res['host_us']:.2f} us/call), plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms; gather, where and "
          f"segment-min chain {res['library_ms']:.4f} ms (device "
          f"{fmt_ms(res['library_device_ms'])}); every iteration bit for bit with the plain "
          f"relaxation, and the chain's segment min with its plain version")
    return res


class TrainProbe:
    """Times a ``Trainer``'s loop on the card: host ms to draw each batch
    (``batch_fn``), ms of each copy to the card and of each step, each
    ending in a synchronisation (the trainer's ``to_device`` and ``step``,
    wrapped on the instance)."""

    def __init__(self, trainer, batch_fn):
        import torch

        self.draw_ms, self.copy_ms, self.step_ms = [], [], []
        to_device, step = trainer.to_device, trainer.step

        def timed(fn, out):
            def run(*args):
                t0 = time.perf_counter()
                res = fn(*args)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
                return res
            return run

        self.batch_fn = timed(batch_fn, self.draw_ms)
        trainer.to_device, trainer.step = timed(to_device, self.copy_ms), timed(step,
                                                                                  self.step_ms)


def tree_errors(got, want) -> list[float]:
    """Max abs difference of each leaf of ``got`` (on the card) from ``want``."""
    from repro_torch.train.tree import tree_leaves

    return [float((g.cpu().float() - w.float()).abs().max()) for g, w in
            zip(tree_leaves(got), tree_leaves(want))]


def within(got, want, tol: float) -> bool:
    """Every leaf of ``got`` within rtol = atol = ``tol`` of ``want``'s."""
    import torch

    from repro_torch.train.tree import tree_leaves

    return all(torch.allclose(g.cpu(), w, rtol=tol, atol=tol)
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def leaf_relative(errors: list[float], want) -> list[float]:
    """Each leaf's max abs error over the leaf's largest entry (0 for a leaf
    of zeros that is matched exactly)."""
    from repro_torch.train.tree import tree_leaves

    scale = [float(w.abs().max()) if w.numel() else 0.0 for w in tree_leaves(want)]
    return [e / s if s else (0.0 if e == 0 else float("inf")) for e, s in zip(errors, scale)]


def deterministic(fn):
    """(``fn()`` under torch.use_deterministic_algorithms, None), or, where
    an op of ``fn`` refuses that mode, (``fn()`` without it, the op's
    message)."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        return fn(), None
    except RuntimeError as e:
        if "deterministic" not in str(e):
            raise
        refused = str(e).splitlines()[0]
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"an op refuses deterministic mode, run without it: {refused}")
    return fn(), refused


def check_gnn_train_steps(dev) -> None:
    """Phase 11 (a): one AdamW step (launch/steps.gnn_train_step) of each
    GNN kind at its published width on the molecule shape, on the card
    against the CPU; GIN and PNA get labels in [0, d_out).

    - The loss within the tolerance of tests/test_torch_gnn.py (TRAIN_TOL).
    - Each gradient leaf within TRAIN_GRAD_SCALE of its largest entry. A
      gradient is only as stable as its inputs let it be: the run prints
      how far the CPU's own gradients move when x and the coordinates are
      perturbed by 1e-7 relative (an ulp), which the card's other rounding
      is. GIN and EGNN move by ~1e-6 of the leaf, PNA by ~1e-3
      (near-ties of its segment max and min change hands, and its std,
      sqrt(var + 1e-5) over a cancelling variance, amplifies an ulp), so
      PNA's bound is 5e-3. NequIP's gradients run through bfloat16
      products and features, so an input that rounds the other way moves a
      gradient by a bfloat16 ulp times its cotangent: 2^-5, as
      tests/test_torch_gnn.py holds it against the JAX package.
    - The new parameters: the card's step is value_and_grad and AdamW bit
      for bit (under deterministic algorithms), and AdamW on the card gives
      the CPU's AdamW of the same gradients within the tolerance. Against
      the CPU's whole step they are printed, not held: AdamW's first step
      is g / (|g| + eps) an entry, so where a gradient entry is at the
      atomic sums' noise the two updates differ by up to 2 lr.

    EGNN's phi_x output layers are scaled by 1e-2, as in the card tests:
    at random full-width weights its coordinates leave float32's range and
    the loss is inf, in the JAX package too."""
    import numpy as np
    import torch

    from repro_torch.configs.base import GNN_SHAPES, get_arch
    from repro_torch.data.pipeline import gnn_molecule_batch
    from repro_torch.launch.steps import gnn_loss, gnn_train_step
    from repro_torch.nn import gnn
    from repro_torch.train.optimizer import OptConfig, make
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.train.tree import tree_leaves

    shape, cpu = GNN_SHAPES["molecule"], torch.device("cpu")
    opt_update = make(OptConfig(name="adamw", lr=1e-3))[1]
    failed = []
    for arch in ("gin-tu", "pna", "egnn", "nequip"):
        cfg = get_arch(arch)
        tol = TRAIN_TOL[cfg.kind]
        rng = np.random.default_rng(11)
        batch = gnn_molecule_batch(rng, shape)
        if cfg.kind in ("gin", "pna"):
            batch["labels"] = rng.integers(0, cfg.d_out, shape.batch_graphs).astype(np.int32)
        params = gnn.init(torch.Generator().manual_seed(0), cfg, shape.d_feat, device="cpu")
        if cfg.kind == "egnn":
            for layer in params["layers"]:
                layer["phi_x"][-1]["w"] *= 1e-2

        def run(d):
            p = gnn.to_device(params, d)
            opt_init, step = gnn_train_step(cfg, shape, device=d)
            state = opt_init(p)
            new_params, _, metrics = step(p, state, batch)
            return metrics["loss"], value_and_grad(gnn_loss, p, cfg, batch)[1], new_params, state

        loss_c, grads_c, new_c, state_c = run(cpu)
        (loss_d, grads_d, new_d, state_d), refused = deterministic(lambda: run(dev))
        grad_rel = leaf_relative(tree_errors(grads_d, grads_c), grads_c)
        param_err = tree_errors(new_d, new_c)
        noise = 0.0
        for seed in range(3):  # the CPU's own gradients under an ulp of input noise
            r = np.random.default_rng(100 + seed)
            nudged = {k: (batch[k] * (1 + 1e-7 * r.standard_normal(batch[k].shape))).astype(
                np.float32) if k in ("x", "coords") else v for k, v in batch.items()}
            g = value_and_grad(gnn_loss, gnn.to_device(params, cpu), cfg, nudged)[1]
            noise = max(noise, max(leaf_relative(tree_errors(g, grads_c), grads_c)))
        adamw_cpu = opt_update(gnn.to_device(grads_d, cpu), state_c, gnn.to_device(params, cpu))[0]
        adamw_err = tree_errors(new_d, adamw_cpu)
        composed = refused is not None or all(torch.equal(a, b) for a, b in zip(
            tree_leaves(new_d), tree_leaves(opt_update(grads_d, state_d,
                                                       gnn.to_device(params, dev))[0])))
        src, dst, em = batch["src"], batch["dst"], batch["emask"]
        pairs = src.astype(np.int64) * len(src) + dst
        dups = int(em.sum()) - len(np.unique(pairs[em]))
        finite = bool(torch.isfinite(loss_d)) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(grads_d))
        print(f"train step {arch} at molecule ({shape.batch_graphs} x {shape.n_nodes} nodes, "
              f"{dups} duplicate edges): loss card {float(loss_d):.6f} CPU {float(loss_c):.6f} "
              f"(diff {abs(float(loss_d) - float(loss_c)):.3e}); gradients: largest max abs diff "
              f"over the leaf's largest entry {max(grad_rel):.3e} (bound "
              f"{TRAIN_GRAD_SCALE[cfg.kind]:.3e}; the CPU's own under 1e-7 relative input noise "
              f"{noise:.3e}); AdamW on the card vs "
              f"the CPU's of the card's gradients {max(adamw_err):.3e}; new parameters vs the "
              f"CPU's step {max(param_err):.3e} (not held); tolerance {tol}")
        grads_ok = max(grad_rel) <= TRAIN_GRAD_SCALE[cfg.kind]
        if not finite:
            failed.append(f"{arch}: the loss or a gradient is not finite")
        if not composed:
            failed.append(f"{arch}: the step is not value_and_grad and AdamW on the card")
        if not (torch.allclose(loss_d.cpu(), loss_c, rtol=tol, atol=tol) and grads_ok
                and within(new_d, adamw_cpu, tol)):
            failed.append(f"{arch}: the card differs from the CPU")
    if failed:
        fail("train steps: " + "; ".join(failed))


def profile_busy(fn) -> tuple[float, float]:
    """(device busy ms, host wall ms) of ``fn`` under torch.profiler, the
    window padded by ``spin_pad``; busy is the self device time of every
    kernel but the spin kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spin_pad()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        spin_pad()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.key) / 1e3
    return busy, wall


def train_mind(dev, params) -> None:
    """Phase 11 (b): MIND at its published width (the dense 2^21 x 64 f32
    table of ``params``) at train_batch. First the loss and every gradient
    on the first rows of one batch, card against CPU; then Trainer.fit for
    TRAIN_MIND_STEPS steps (a finite loss at each) with the loop's split
    timed; the device's busy share over a short fit under the profiler; then
    TRAIN_MIND_FIXED_STEPS steps on one fixed batch, where the loss must
    fall."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.base import RECSYS_SHAPES, get_arch
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.nn import recsys
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig, value_and_grad
    from repro_torch.train.tree import tree_leaves

    cfg, shape = get_arch("mind"), RECSYS_SHAPES["train_batch"]
    batch_fn = make_batch_fn("recsys", cfg, shape, seed=0)
    batch0 = batch_fn(0)
    rows = TRAIN_MIND_CHECK_ROWS
    small = {k: (v if k == "negatives" else v[:rows]) for k, v in batch0.items()}
    on_cpu = value_and_grad(recsys.loss_fn, recsys.to_device(params, torch.device("cpu")),
                            cfg, small)
    on_card = value_and_grad(recsys.loss_fn, params, cfg, small)
    loss_err = abs(float(on_card[0]) - float(on_cpu[0]))
    grad_err = tree_errors(on_card[1], on_cpu[1])
    grad_rel = leaf_relative(grad_err, on_cpu[1])
    print(f"MIND train check on {rows} rows of train_batch ({cfg.n_negatives} negatives): loss "
          f"card {float(on_card[0]):.7f} CPU {float(on_cpu[0]):.7f} (diff {loss_err:.3e}); "
          f"gradients max abs diff {max(grad_err):.3e} (items {grad_err[0]:.3e}), largest over "
          f"its leaf's largest entry {max(grad_rel):.3e} (items {grad_rel[0]:.3e}); tolerance "
          f"{TRAIN_TOL['mind']}, gradients {TRAIN_GRAD_SCALE['mind']} of the leaf")
    if not (torch.allclose(on_card[0].cpu(), on_cpu[0], rtol=TRAIN_TOL["mind"],
                           atol=TRAIN_TOL["mind"])
            and max(grad_rel) <= TRAIN_GRAD_SCALE["mind"]):
        fail("MIND train check: the card differs from the CPU")
    del on_cpu, on_card

    opt = OptConfig(name="adamw", lr=1e-3)

    def loss_fn(p, b):
        return recsys.loss_fn(p, cfg, b)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(loss_fn, lambda: params, opt,
                      TrainerConfig(num_steps=TRAIN_MIND_STEPS, log_every=1), device=dev)
    probe = TrainProbe(trainer, batch_fn)
    t0 = time.perf_counter()
    state = trainer.fit(probe.batch_fn)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in trainer.history]
    if len(losses) != TRAIN_MIND_STEPS or not np.isfinite(losses).all():
        fail(f"MIND training: losses {losses}")
    del state
    step_ms = statistics.median(probe.step_ms[1:])
    short = Trainer(loss_fn, lambda: params, opt, TrainerConfig(num_steps=3, log_every=3),
                    device=dev)
    busy, fit_wall = profile_busy(lambda: short.fit(batch_fn))
    print(f"MIND training at train_batch ({shape.batch} x {cfg.hist_len} histories, "
          f"{cfg.n_negatives} shared negatives, table {cfg.n_items} x {cfg.embed_dim} f32, dense "
          f"gradient): {TRAIN_MIND_STEPS} steps in {wall:.1f} s; per step median ms (steps 2 on, "
          f"synchronised): step {step_ms:.3f}, batch draw (host) "
          f"{statistics.median(probe.draw_ms):.3f}, copy to the card "
          f"{statistics.median(probe.copy_ms):.3f}; first step {probe.step_ms[0]:.3f}; a 3-step "
          f"fit under the profiler: device busy {busy:.3f} ms of {fit_wall:.3f} ms (busy share "
          f"{busy / fit_wall:.4f}; {busy / 3:.3f} ms a step, {busy / 3 / step_ms:.4f} of a "
          f"step's time); peak device memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} "
          f"GiB above the earlier phases' tensors)")

    fixed = Trainer(loss_fn, lambda: params, opt,
                    TrainerConfig(num_steps=TRAIN_MIND_FIXED_STEPS, log_every=5), device=dev)
    fixed.fit(lambda step: batch0)
    first, last = fixed.history[0]["loss"], fixed.history[-1]["loss"]
    print(f"MIND on one fixed batch: loss {first:.6f} at step 1, {last:.6f} at step "
          f"{fixed.history[-1]['step']}")
    if not last < first:
        fail(f"MIND training: the loss on one fixed batch did not fall ({first} -> {last})")


def train_gin(dev, g2) -> None:
    """Phase 11 (c): GIN (gin-tu at its published width) on minibatch_lg
    block graphs sampled from ``g2`` (the ``lj`` graph of phase 5), labels
    in [0, d_out). A clean Trainer.fit of TRAIN_GIN_STEPS steps, timed;
    then the same with checkpoints every TRAIN_GIN_CKPT_EVERY steps and
    failures injected at TRAIN_GIN_FAIL_AT: it restarts once per failure,
    and its loss history and final state equal the clean run's bit for bit
    under torch.use_deterministic_algorithms (to rtol 1e-6, naming the op,
    if an op of the path refuses that mode)."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.base import GNN_SHAPES, get_arch
    from repro_torch.data.pipeline import gnn_minibatch
    from repro_torch.launch.steps import gnn_loss
    from repro_torch.nn import gnn
    from repro_torch.train.ft import FailureInjector
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import tree_leaves

    cfg, shape = get_arch("gin-tu"), GNN_SHAPES["minibatch_lg"]

    def batch_fn(step):
        # the default 47 classes against 16 logits would give a NaN loss,
        # as in the JAX package: labels in [0, d_out) here
        return gnn_minibatch(np.random.default_rng((0, step)), g2, shape, shape.d_feat,
                             n_classes=cfg.d_out)

    def trainer(**ckpt):
        return Trainer(lambda p, b: gnn_loss(p, cfg, b),
                       lambda: gnn.init(torch.Generator().manual_seed(0), cfg, shape.d_feat,
                                        device=dev),
                       OptConfig(name="adamw", lr=1e-3),
                       TrainerConfig(num_steps=TRAIN_GIN_STEPS, log_every=1, **ckpt),
                       device=dev)

    def runs():
        clean = trainer()
        probe = TrainProbe(clean, batch_fn)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        clean_state = clean.fit(probe.batch_fn)
        peak = torch.cuda.max_memory_allocated(dev)
        scratch = os.path.join(ROOT, "build")
        os.makedirs(scratch, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            faulty = trainer(ckpt_dir=d, ckpt_every=TRAIN_GIN_CKPT_EVERY)
            state = faulty.fit(batch_fn, injector=FailureInjector(fail_at=TRAIN_GIN_FAIL_AT))
        return clean, clean_state, faulty, state, probe, peak - base, peak

    (clean, clean_state, faulty, state, probe, above, peak), refused = deterministic(runs)

    b = batch_fn(0)
    print(f"GIN training at minibatch_lg ({shape.batch_nodes} seeds, fanout {shape.fanout}, "
          f"d_feat {shape.d_feat}) over the lj graph of phase 5: {b['x'].shape[0]} nodes and "
          f"{b['src'].shape[0]} edges a block ({int(b['emask'].sum())} valid); per step median "
          f"ms (steps 2 on, synchronised): step {statistics.median(probe.step_ms[1:]):.3f}, "
          f"batch draw (host) {statistics.median(probe.draw_ms):.3f}, copy to the card "
          f"{statistics.median(probe.copy_ms):.3f}; peak device memory {peak / 2**30:.3f} GiB "
          f"({above / 2**30:.3f} GiB above the earlier phases' tensors); deterministic "
          f"{'no' if refused else 'yes'}")
    losses = [h["loss"] for h in clean.history]
    if len(losses) != TRAIN_GIN_STEPS or not np.isfinite(losses).all():
        fail(f"GIN training: losses {losses}")
    replayed = {h["step"]: h for h in faulty.history}
    print(f"GIN restarts: {faulty.restarts} (failures at steps {TRAIN_GIN_FAIL_AT}, checkpoints "
          f"every {TRAIN_GIN_CKPT_EVERY}); {len(faulty.history)} steps run for "
          f"{TRAIN_GIN_STEPS}; loss {losses[0]:.6f} at step 1, {losses[-1]:.6f} at step "
          f"{TRAIN_GIN_STEPS}")
    if faulty.restarts != len(TRAIN_GIN_FAIL_AT):
        fail(f"GIN training: {faulty.restarts} restarts for {len(TRAIN_GIN_FAIL_AT)} failures")
    if sorted(replayed) != list(range(1, TRAIN_GIN_STEPS + 1)):
        fail(f"GIN training: the restarted run logged steps {sorted(replayed)}")
    pairs = list(zip(tree_leaves(state), tree_leaves(clean_state)))
    if refused is None:
        same = all(torch.equal(a, b) for a, b in pairs) and all(
            replayed[h["step"]] == h for h in clean.history) and all(
            h == replayed[h["step"]] for h in faulty.history)
        how = "bit for bit"
    else:
        same = all(torch.allclose(a, b, rtol=1e-6, atol=0) for a, b in pairs) and np.allclose(
            [replayed[h["step"]]["loss"] for h in clean.history], losses, rtol=1e-6, atol=0)
        how = "to rtol 1e-6"
    print(f"GIN restarted run against the clean run ({how}): "
          f"{'the same' if same else 'DIFFERENT'} loss history and final state "
          f"(max abs diff {max(float((a - b).abs().max()) for a, b in pairs):.3e})")
    if not same:
        fail("GIN training: the restarted run differs from the clean run")


def run_training(dev, params, g2) -> None:
    """Phase 11: training, which launches no kernel of the port (the JAX
    package's train steps read the table with impl="jnp", and no
    pallas_call there has a backward): K1's, K2's and K3's launch counts are
    0 at its start and still 0 at its end."""
    from repro_torch.kernels.embedding_bag.embedding_bag import hot_bag_hot_part
    from repro_torch.kernels.hot_gather.hot_gather import (hot_gather_hot_part,
                                                           hot_gather_segment_sum)

    counters = (hot_gather_hot_part, hot_gather_segment_sum, hot_bag_hot_part)
    for c in counters:
        c.launches = 0
    phase("11a (GNN train steps, card vs CPU)", check_gnn_train_steps, dev)
    phase("11b (MIND training)", train_mind, dev, params)
    phase("11c (GIN training with restarts)", train_gin, dev, g2)
    launched = {c.__name__: c.launches for c in counters}
    print(f"training: kernel launches {launched}")
    if any(launched.values()):
        fail(f"training launched a kernel: {launched}")


def grasp_steps(step, params, state, block, n: int):
    """``n`` steps from (params, state): each step's loss and CUDA-event ms,
    and the last parameters and state."""
    import torch

    losses, ms = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m = step(params, state, block)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(m["loss"])
    return losses, ms, params, state


def recording(opt_update, seen: list):
    """``opt_update`` that keeps each step's (summed) gradients in ``seen``."""
    def update(grads, state, params):
        seen.append(grads)
        return opt_update(grads, state, params)
    return update


def grasp_real_size(dev, g2) -> None:
    """Phase 12 (a): GIN (gin-tu at its published width) trained by the
    GRASP cell's step, launch.steps.gnn_train_step's GRASP branch, over the
    lj graph of phase 5 on one rank: the cell's spec over the stand-in's
    counts, its partition (no edge dropped), one step against the
    unpartitioned loss and AdamW on the same weights on the card (the loss
    to 1e-5 relative, each summed gradient leaf and new parameter leaf
    within GRASP_REAL_LEAF_BOUND of its largest entry), then GRASP_STEPS
    steps of each schedule (ms a step, peak memory) and one profiled
    step."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import convert
    from repro_torch.configs.base import GNN_SHAPES, get_arch
    from repro_torch.dist import collectives as coll
    from repro_torch.launch.steps import N_CLASSES, gnn_loss, gnn_train_step
    from repro_torch.nn import gnn
    from repro_torch.train.optimizer import OptConfig, make
    from repro_torch.train.trainer import value_and_grad

    cpu = torch.device("cpu")
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"card memory {total} bytes; HOT_REPLICA_BUDGET_BYTES ({coll.HOT_REPLICA_BUDGET_BYTES} "
          f"bytes) is {coll.HOT_REPLICA_BUDGET_BYTES / total:.4%} of it")
    cfg = get_arch("gin-tu")
    # ogb_products' counts cannot hold the stand-in's 4.19M vertices: the
    # cell's own spec call over the stand-in's counts
    shape = dataclasses.replace(GNN_SHAPES["ogb_products"], n_nodes=g2.num_nodes,
                                n_edges=g2.num_edges)
    opt_init, step, spec = gnn_train_step(cfg, shape, device=dev)
    if spec != coll.partition_spec_for(g2.num_nodes, g2.num_edges, 1,
                                       hot_budget_bytes=coll.HOT_REPLICA_BUDGET_BYTES,
                                       elem_bytes=shape.d_feat * 4):
        fail("GRASP training: gnn_train_step's spec is not the cell's")
    t0 = time.perf_counter()
    part = coll.grasp_partition(g2, spec)
    part_s = time.perf_counter() - t0
    kept = int(part["emask"].sum())
    print(f"GRASP partition of the lj graph of phase 5 ({g2.num_nodes} vertices, {g2.num_edges} "
          f"edges) for 1 rank: {dataclasses.asdict(spec)}; dropped {part['dropped']}, pad slots "
          f"{spec.e_loc - kept} of {spec.e_loc} (edst 0, masked); the hot prefix is the source of "
          f"{float((g2.indices < spec.hot).mean()):.4f} of the edges; grasp_partition "
          f"{part_s:.1f} s on the host")
    if part["dropped"] != 0:
        fail(f"GRASP training: the partition dropped {part['dropped']} edges")

    rng = np.random.default_rng(0)
    x = rng.standard_normal((spec.num_nodes, shape.d_feat), dtype=np.float32)
    labels = rng.integers(0, cfg.d_out, spec.num_nodes).astype(np.int32)
    params = gnn.init(torch.Generator().manual_seed(0), cfg, shape.d_feat, device=dev)
    opt_update = make(OptConfig(name="adamw", lr=1e-3))[1]

    # the unpartitioned step on the same weights, on the card
    ref = {"x": torch.from_numpy(x).to(dev), "src": torch.from_numpy(g2.indices).to(dev),
           "dst": torch.from_numpy(g2.dst_ids()).to(dev),
           "emask": torch.ones(g2.num_edges, dtype=torch.bool, device=dev),
           "labels": torch.from_numpy(labels).to(dev)}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss_u, grads_u = value_and_grad(gnn_loss, params, cfg, ref)
    new_u = opt_update(grads_u, opt_init(params), params)[0]
    end.record()
    end.synchronize()
    print(f"unpartitioned GIN step on the card (gnn_loss + AdamW, first call): "
          f"{start.elapsed_time(end):.3f} ms, peak "
          f"{(torch.cuda.max_memory_allocated(dev) - base) / 2**30:.3f} GiB above the earlier "
          f"tensors; loss {float(loss_u):.7f}")
    del ref
    grads_u, new_u = gnn.to_device(grads_u, cpu), gnn.to_device(new_u, cpu)

    block = convert.grasp_batch_from_numpy(coll.grasp_batch(x, labels, part, spec), 0, dev)
    del x, part
    torch.cuda.empty_cache()
    seen = []
    checked = coll.make_grasp_gin_step(spec, cfg, shape.d_feat, N_CLASSES, None,
                                       recording(opt_update, seen), device=dev)
    new_g, _, m = checked(params, opt_init(params), block)
    loss_g = float(m["loss"])
    rel = abs(loss_g - float(loss_u)) / abs(float(loss_u))
    grad_rel = leaf_relative(tree_errors(seen[0], grads_u), grads_u)
    param_rel = leaf_relative(tree_errors(new_g, new_u), new_u)
    print(f"GRASP step (pipelined) against the unpartitioned step: loss {loss_g:.7f} (relative "
          f"diff {rel:.3e}, bound 1e-5); largest leaf max abs diff over the leaf's largest "
          f"entry: gradients {max(grad_rel):.3e} (leaf {int(np.argmax(grad_rel))}), new "
          f"parameters {max(param_rel):.3e} (leaf {int(np.argmax(param_rel))}); bound "
          f"{GRASP_REAL_LEAF_BOUND:.0e}")
    if not (np.isfinite(loss_g) and rel <= 1e-5 and max(grad_rel) <= GRASP_REAL_LEAF_BOUND
            and max(param_rel) <= GRASP_REAL_LEAF_BOUND):
        fail("GRASP training: the GRASP step differs from the unpartitioned step")
    del seen, new_g, grads_u, new_u

    sequential = coll.make_grasp_gin_step(spec, cfg, shape.d_feat, N_CLASSES, None, opt_update,
                                          overlap=False, device=dev)
    for label, fn in (("pipelined", step), ("sequential", sequential)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        losses, ms, p, s = grasp_steps(fn, params, opt_init(params), block, GRASP_STEPS)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        losses = [float(v) for v in losses]
        print(f"GRASP GIN {label} at the cell's defaults: {GRASP_STEPS} steps, median "
              f"{statistics.median(ms[1:]):.3f} ms a step over steps 2 on (first {ms[0]:.3f}; "
              f"all {[round(v, 3) for v in ms]}), losses {losses}, peak {peak / 2**30:.3f} GiB "
              f"above the earlier tensors, {wall:.1f} s")
        if not np.isfinite(losses).all():
            fail(f"GRASP training {label}: losses {losses}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spin_pad()
        step(p, s, block)
        spin_pad()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "spin_kernel" not in e.key),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"GRASP GIN pipelined, one profiled step: device busy {busy:.3f} ms; top kernels: "
          + "; ".join(f"{e.key[:70]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in kernels[:8]))


def grasp_schedules_exact(dev, g) -> None:
    """Phase 12 (b): the two schedules of the GRASP step on ``g`` (a quarter
    of its vertices hot, the cell's pub_frac and edge_slack, d_feat 100,
    gin-tu), GRASP_EXACT_STEPS steps each, loss and parameters bit for bit
    under torch.use_deterministic_algorithms."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs.base import get_arch
    from repro_torch.dist import collectives as coll
    from repro_torch.nn import gnn
    from repro_torch.train.optimizer import OptConfig, make
    from repro_torch.train.tree import tree_leaves

    cfg, d_feat = get_arch("gin-tu"), 100
    spec = coll.partition_spec_for(g.num_nodes, g.num_edges, 1, hot=g.num_nodes // 4)
    part = coll.grasp_partition(g, spec)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((spec.num_nodes, d_feat), dtype=np.float32)
    labels = rng.integers(0, cfg.d_out, spec.num_nodes).astype(np.int32)
    block = convert.grasp_batch_from_numpy(coll.grasp_batch(x, labels, part, spec), 0, dev)
    params = gnn.init(torch.Generator().manual_seed(1), cfg, d_feat, device=dev)
    opt_init, opt_update = make(OptConfig(name="adamw", lr=1e-3))

    def runs():
        out = {}
        for overlap in (False, True):
            step = coll.make_grasp_gin_step(spec, cfg, d_feat, cfg.d_out, None, opt_update,
                                            overlap=overlap, device=dev)
            losses, ms, p, s = grasp_steps(step, params, opt_init(params), block,
                                           GRASP_EXACT_STEPS)
            out[overlap] = (losses, p, s, ms)
        return out

    out, refused = deterministic(runs)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(out[False][:3]),
                                                 tree_leaves(out[True][:3])))
    print(f"GRASP schedules on {g.num_nodes} vertices, {g.num_edges} edges (hot {spec.hot}, "
          f"cold {spec.cold_per_dev}, c_pub {spec.c_pub}, e_loc {spec.e_loc}, dropped "
          f"{part['dropped']}), {GRASP_EXACT_STEPS} steps each under deterministic algorithms: "
          f"pipelined against sequential {'bit for bit' if same else 'DIFFERENT'} (losses "
          f"{[float(v) for v in out[True][0]]}; ms a step sequential "
          f"{[round(v, 3) for v in out[False][3]]}, pipelined {[round(v, 3) for v in out[True][3]]})")
    if refused is not None or not same:
        fail("GRASP training: the pipelined schedule differs from the sequential one"
             + (f" (deterministic mode refused: {refused})" if refused else ""))


def grasp_card_vs_cpu(dev, g) -> None:
    """Phase 12 (c): one GRASP step (gin-tu at full width, d_feat 100) on
    ``g`` (the tw graph of the quickstart) with GRASP_CHECK_HOT hot rows, on
    the card (the NCCL rank) against the CPU (a gloo group of the same
    rank), with phase 11's GIN tolerances: the loss within TRAIN_TOL, each
    summed gradient leaf within TRAIN_GRAD_SCALE of its largest entry, and
    AdamW on the card within TRAIN_TOL of the CPU's AdamW of the card's
    gradients. The card runs under deterministic algorithms: with atomic
    sums its gradients move by up to 4.5e-6 of a leaf from run to run and
    came within 9.6e-6 / 1.02e-5 of the CPU's (scripts/grasp_step_noise.py);
    deterministic, 8.4e-6 every run."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_arch
    from repro_torch.dist import collectives as coll
    from repro_torch.nn import gnn
    from repro_torch.train.optimizer import OptConfig, make

    cfg, d_feat, cpu = get_arch("gin-tu"), 100, torch.device("cpu")
    tol = TRAIN_TOL["gin"]
    spec = coll.partition_spec_for(g.num_nodes, g.num_edges, 1, hot=GRASP_CHECK_HOT)
    part = coll.grasp_partition(g, spec)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((spec.num_nodes, d_feat), dtype=np.float32)
    labels = rng.integers(0, cfg.d_out, spec.num_nodes).astype(np.int32)
    batch = coll.grasp_batch(x, labels, part, spec)
    batch = {k: (v if k == "x_hot" else v[0]) for k, v in batch.items()}
    params = gnn.init(torch.Generator().manual_seed(2), cfg, d_feat, device="cpu")
    opt_init, opt_update = make(OptConfig(name="adamw", lr=1e-3))
    def run(d, group):
        seen = []
        step = coll.make_grasp_gin_step(spec, cfg, d_feat, cfg.d_out, group,
                                        recording(opt_update, seen), device=d)
        p = gnn.to_device(params, d)
        s = opt_init(p)
        _, _, m = step(p, s, batch)
        return m["loss"], seen[0], p, s

    loss_c, grads_c, _, _ = run(cpu, dist.new_group(backend="gloo"))
    (loss_d, grads_d, p_d, s_d), refused = deterministic(lambda: run(dev, None))
    if refused is not None:
        fail(f"GRASP training: deterministic mode refused the card-vs-CPU step: {refused}")
    grad_rel = leaf_relative(tree_errors(grads_d, grads_c), grads_c)
    adamw_card = opt_update(grads_d, s_d, p_d)[0]
    adamw_cpu = opt_update(*(gnn.to_device(t, cpu) for t in (grads_d, s_d, p_d)))[0]
    adamw_err = tree_errors(adamw_card, adamw_cpu)
    print(f"GRASP step card vs CPU on {g.num_nodes} vertices, {g.num_edges} edges (hot "
          f"{spec.hot}, c_pub {spec.c_pub}, e_loc {spec.e_loc}): loss card {float(loss_d):.7f} "
          f"CPU {float(loss_c):.7f}; gradients, largest leaf max abs diff over the leaf's largest "
          f"entry {max(grad_rel):.3e} (bound {TRAIN_GRAD_SCALE['gin']:.0e}); AdamW on the card vs "
          f"the CPU's of the card's gradients {max(adamw_err):.3e}; tolerance {tol}")
    if not (torch.isfinite(loss_d) and torch.allclose(loss_d.cpu(), loss_c, rtol=tol, atol=tol)
            and max(grad_rel) <= TRAIN_GRAD_SCALE["gin"] and within(adamw_card, adamw_cpu, tol)):
        fail("GRASP training: the card differs from the CPU")


def run_grasp_training(dev, g2, qs_graph) -> None:
    """Phase 12: the GRASP-partitioned GIN train step (dist.collectives) on
    one NCCL rank of a world-size-1 process group (a file:// store under
    build/), which launches no kernel of the port: the JAX step gathers with
    jnp.take and reduces with segment_sum, and no pallas_call has a
    backward. K1's, K2's and K3's launch counts are 0 at its start and still
    0 at its end."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.kernels.embedding_bag.embedding_bag import hot_bag_hot_part
    from repro_torch.kernels.hot_gather.hot_gather import (hot_gather_hot_part,
                                                           hot_gather_segment_sum)

    counters = (hot_gather_hot_part, hot_gather_segment_sum, hot_bag_hot_part)
    for c in counters:
        c.launches = 0
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        phase("12a (GRASP GIN at real size)", grasp_real_size, dev, g2)
        torch.cuda.empty_cache()
        phase("12b (GRASP schedules bit for bit)", grasp_schedules_exact, dev,
              dbg_graph("lj", GRASP_EXACT_SCALE))
        phase("12c (GRASP step, card vs CPU)", grasp_card_vs_cpu, dev, qs_graph)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    launched = {c.__name__: c.launches for c in counters}
    print(f"GRASP training: kernel launches {launched}")
    if any(launched.values()):
        fail(f"GRASP training launched a kernel: {launched}")


# ---------------------------------------------------------------------------
# phase 13: the gateway and seeded chaos over MIND's serve engine
# ---------------------------------------------------------------------------
def gateway_requests(cfg, n: int, seed: int) -> list:
    """``n`` (history, candidates) pairs drawn from ``seed``: a full
    Zipf-1.1 history and GW_CANDIDATES Zipf-1.1 candidates each."""
    import numpy as np

    from repro_torch.data.pipeline import zipf_ids

    rng = np.random.default_rng(seed)
    return [(zipf_ids(rng, (cfg.hist_len,), cfg.n_items, a=1.1),
             zipf_ids(rng, (GW_CANDIDATES,), cfg.n_items, a=1.1)) for _ in range(n)]


def mind_engine(dev, params, cfg):
    """MIND's serve engine on the card over phase 8's cache (128 MiB, GRASP
    pinning half) behind a (32, 256) batcher, warmed up."""
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import RecsysServeEngine
    from repro_torch.serve.scheduler import SchedulerConfig

    engine = RecsysServeEngine(params, cfg, CacheConfig(MIND_CACHE_BYTES, 0.5, "rrpv"),
                               SchedulerConfig(max_batch=GW_MAX_BATCH, max_queue=GW_MAX_QUEUE),
                               device=dev)
    engine.warmup(candidates=GW_CANDIDATES)
    return engine


def drive(client, reqs: list, workers: int) -> tuple[list, list, list, list]:
    """Send ``reqs`` through ``client.score`` from ``workers`` threads in a
    closed loop. Returns, in request order, each outcome ("done" or the
    error's kind), scores (None unless done), client ms and error text.
    A client thread still running after GW_JOIN_S fails the script."""
    import threading

    from repro_torch.gateway import GatewayError

    n = len(reqs)
    outcomes, scores, ms, errors = [None] * n, [None] * n, [None] * n, [None] * n
    lock, it = threading.Lock(), iter(range(n))

    def worker():
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                scores[i] = client.score(*reqs[i], timeout_s=GW_JOIN_S)
                outcomes[i] = "done"
            except GatewayError as e:
                outcomes[i], errors[i] = e.kind, f"{type(e).__name__}: {e}"
            except Exception as e:  # noqa: BLE001 — recorded; the caller fails on it
                outcomes[i], errors[i] = "error", repr(e)
            ms[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(GW_JOIN_S)
    hung = sum(t.is_alive() for t in threads)
    if hung:
        fail(f"gateway: {hung} client thread(s) still waiting after {GW_JOIN_S} s")
    return outcomes, scores, ms, errors


def all_served(label: str, outcomes: list, errors: list) -> None:
    """Fail with the first error's text unless every request was served."""
    bad = [i for i, o in enumerate(outcomes) if o != "done"]
    if bad:
        fail(f"{label}: {len(bad)} of {len(outcomes)} requests not served; request "
             f"{bad[0]}: {errors[bad[0]]}")


def gateway_healthy(dev, params, cfg) -> tuple:
    """Phase 13 (a): MIND at full width behind a supervised gateway with the
    breaker on, 16 client threads in a closed loop. Every request is
    served; each response is the engine's output for it bit for bit (the
    wire carries float32 scores exactly) and the dense serve_scores on the
    card within 1e-5; K1's hot-part mode launches once per lookup with hot
    references, bit for bit on one batch's hot ids. Returns K1's entry for
    the path "mind gateway", the engine, the requests and their scores."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.gateway import EnginePump, GatewayClient, GatewayServer
    from repro_torch.kernels.embedding_bag.embedding_bag import hot_bag_hot_part
    from repro_torch.kernels.hot_gather.hot_gather import (
        hot_gather_hot_part,
        hot_gather_segment_sum,
    )
    from repro_torch.nn import recsys

    engine = mind_engine(dev, params, cfg)
    reqs = gateway_requests(cfg, GW_REQUESTS, seed=13)
    counters = (hot_gather_hot_part, hot_gather_segment_sum, hot_bag_hot_part)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    server = GatewayServer({"score": EnginePump(engine, "score")}).start()
    try:
        client = GatewayClient(server.url, timeout_s=GW_JOIN_S, retries=0)
        with StreamProbe() as probe:
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            outcomes, served, ms, errors = drive(client, reqs, GW_CLIENTS)
            wall = time.perf_counter() - t0
            launched = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated(dev)
        health = client.health()
    finally:
        server.stop()
    all_served("gateway (a)", outcomes, errors)
    snap = engine.metrics.snapshot()
    c = snap["counters"]
    if c.get("completed") != GW_REQUESTS or any(c.get(k, 0) for k in ("failed", "shed",
                                                                      "rejected")):
        fail(f"gateway (a): server counters {c}")
    if health["status"] != "ok":
        fail(f"gateway (a): /healthz {health}")

    # the wire: each response is the engine's own output for its request
    produced = {}
    for payloads, out in probe.batches:
        for pl, row in zip(payloads, out):
            produced.setdefault((pl["hist"].tobytes(), pl["candidates"].tobytes()), []).append(row)
    for i, (hist, cand) in enumerate(reqs):
        rows = produced.get((hist.tobytes(), cand.tobytes()), [])
        if not any(np.array_equal(served[i], row) for row in rows):
            fail(f"gateway (a): request {i}'s scores are not the engine's output bit for bit")
    got = np.stack(served)
    dense = np.concatenate([recsys.serve_scores(params, cfg, {
        "hist": np.stack([h for h, _ in reqs[k:k + 512]]),
        "hist_mask": np.ones((len(reqs[k:k + 512]), cfg.hist_len), bool),
        "candidates": np.stack([q for _, q in reqs[k:k + 512]]),
    }, impl="plain").cpu().numpy() for k in range(0, GW_REQUESTS, 512)])
    diff = float(np.abs(got - dense).max())
    if got.shape != (GW_REQUESTS, GW_CANDIDATES) or not np.isfinite(got).all():
        fail(f"gateway (a): not finite scores of shape ({GW_REQUESTS}, {GW_CANDIDATES})")
    if not np.allclose(got, dense, rtol=1e-5, atol=1e-5):
        fail(f"gateway (a): served scores differ from the dense serve_scores by {diff:.3e}")

    hot_lookups = sum(hit for _, hit in probe.lookups)
    k1 = launched["hot_gather_hot_part"]
    if hot_lookups < 1 or k1 != hot_lookups:
        fail(f"gateway (a): {k1} K1 launches for {hot_lookups} lookups with hot references")

    sizes = [len(pl) for pl, _ in probe.batches]
    lookup = [a + b for a, b in zip(probe.lookup_ms[::2], probe.lookup_ms[1::2])]
    lookup_cpu = [a + b for a, b in zip(probe.lookup_cpu_ms[::2], probe.lookup_cpu_ms[1::2])]
    routed = [f - lk for f, lk in zip(probe.forward_ms, lookup)]
    e2e, wait = snap["latency"]["e2e"], snap["latency"]["queue_wait"]
    p50, p99 = (float(np.percentile(ms, q)) for q in (50, 99))
    fwd = statistics.median(probe.forward_ms)
    print(f"gateway (a): {GW_REQUESTS} requests from {GW_CLIENTS} clients in {wall:.3f} s, "
          f"{GW_REQUESTS / wall:.1f} requests/s; client p50 {p50:.3f} ms p99 {p99:.3f} ms; "
          f"server e2e p50 {e2e['p50_s'] * 1e3:.3f} ms p99 {e2e['p99_s'] * 1e3:.3f} ms, queue "
          f"wait p50 {wait['p50_s'] * 1e3:.3f} ms; hit rate {snap['hit_rate']:.6f} (hot "
          f"{c.get('hot_hits', 0)} cold {c.get('cold_hits', 0)} misses {c['misses']}); "
          f"{len(sizes)} batches, mean size {statistics.mean(sizes):.2f}, largest {max(sizes)}")
    print(f"gateway (a) per batch (medians): cache lookups (host, both) "
          f"{statistics.median(lookup):.3f} ms (the pump thread on the CPU "
          f"{statistics.median(lookup_cpu):.3f} ms of it), routed forward (card) "
          f"{statistics.median(routed):.3f} ms, forward total {fwd:.3f} ms; HTTP, JSON, queue "
          f"and pump: client p50 less the forward {p50 - fwd:.3f} ms; served scores vs dense "
          f"max abs diff {diff:.3e}, all {GW_REQUESTS} bit for bit the engine's; launches "
          f"{launched}; peak device memory {peak / 2**30:.3f} GiB")

    # K1 at this path's shapes: the history and candidate lookups of the
    # batch of median size
    j = sorted(range(len(sizes)), key=lambda b: sizes[b])[len(sizes) // 2]
    hot_size, items = engine.cache.hot_size, params["items"]
    mix, counts, err = [], [], 0.0
    for k, kind in enumerate(("history", "candidates")):
        ids = probe.lookups[2 * j + k][0]
        idx = torch.as_tensor(np.where(ids < hot_size, ids, -1).astype(np.int32)).to(dev)
        err = max(err, check_k1_exact(f"mind gateway {kind} (batch of {sizes[j]})",
                                      items[:hot_size], idx))
        mix.append((items, hot_size, idx))
        counts.append(sum(hit for _, hit in probe.lookups[k::2]))
    entry = k1_numbers("mind gateway", mix, counts, err, two_tier=False)

    # the card's busy share over a window of 512 more requests, profiled
    busy_reqs = gateway_requests(cfg, GW_BUSY_REQUESTS, seed=14)
    server = GatewayServer({"score": EnginePump(engine, "score")}).start()
    try:
        client = GatewayClient(server.url, timeout_s=GW_JOIN_S, retries=0)
        window = []
        busy, wall_ms = profile_busy(lambda: window.append(drive(client, busy_reqs, GW_CLIENTS)))
    finally:
        server.stop()
    all_served("gateway (a) profiled window", window[0][0], window[0][3])
    share = f"{busy / wall_ms:.4f}" if busy > 0 else "not measured"
    print(f"gateway (a) busy share under torch.profiler: {GW_BUSY_REQUESTS} requests in "
          f"{wall_ms:.3f} ms, card busy {busy:.3f} ms: {share} "
          f"({GW_BUSY_REQUESTS / wall_ms * 1e3:.1f} requests/s while profiled)")
    return entry, engine, reqs, served


class Breakable:
    """Engine wrapper with a persistent-failure switch: while ``failing``,
    every forward raises an InjectedFault, a fault that does not go away
    on its own (benchmarks/chaos_smoke.py's ``_Breakable``)."""

    def __init__(self, engine) -> None:
        self._engine = engine
        self.batcher = engine.batcher
        self.failing = False
        self.forwards = 0

    def forward(self, payloads):
        from repro_torch.chaos import InjectedFault

        self.forwards += 1
        if self.failing:
            raise InjectedFault("chaos: persistent engine fault")
        return self._engine.forward(payloads)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def chaos_run(engine, cfg, workers: int, breaker: bool) -> dict:
    """One supervised run of CHAOS_REQUESTS requests through ChaosEngine
    (CHAOS_FAULTS) and a ChaosClient with post-execution resets
    (benchmarks/chaos_smoke.py's ``_run_workload``). Returns the outcomes
    and errors in request order, the injection log, the supervisor's,
    dedupe's and client's stats, the engine's counters over the run, and
    the exception of every batch the batcher failed."""
    from repro_torch.chaos import ChaosClient, ChaosEngine, FaultSchedule, FaultSpec
    from repro_torch.gateway import EnginePump, GatewayServer

    schedule = FaultSchedule(FaultSpec(**CHAOS_FAULTS))
    batcher, failures = engine.batcher, []

    def recording_fail(batch, exc, _fail=batcher.fail):
        if batch:   # close() fails out the (empty) queue too
            failures.append(exc)
        _fail(batch, exc)

    batcher.fail = recording_fail
    before = dict(engine.metrics.counters)
    server = GatewayServer({"score": EnginePump(ChaosEngine(engine, schedule), "score")},
                           supervisor_config=CHAOS_SUPERVISOR, breaker=breaker,
                           breaker_config=CHAOS_BREAKER).start()
    try:
        client = ChaosClient(server.url, schedule, reset_mode="post", timeout_s=20.0,
                             retries=8, backoff_s=0.02, backoff_cap_s=0.2)
        outcomes, _, _, errors = drive(client, gateway_requests(cfg, CHAOS_REQUESTS, seed=3),
                                       workers)
        supervisor, dedupe = server.supervisors["score"].stats(), server.dedupe.stats()
    finally:
        server.stop()
        del batcher.fail
    after = engine.metrics.counters
    return {"outcomes": outcomes, "errors": errors, "log": schedule.log.entries(),
            "injected": schedule.log.summary(), "supervisor": supervisor, "dedupe": dedupe,
            "client": dict(client.stats), "failures": failures,
            "counters": {k: after.get(k, 0) - before.get(k, 0) for k in after}}


def only_injected(label: str, r: dict) -> None:
    """Fail with its text on any failure that is not an injected fault:
    a batch failed with another exception, or a request's error."""
    from repro_torch.chaos import InjectedFault

    for exc in r["failures"]:
        if not isinstance(exc, InjectedFault):
            fail(f"{label}: a batch failed with {type(exc).__name__}: {exc}")
    for o, e in zip(r["outcomes"], r["errors"]):
        if o == "failed" and "chaos:" not in e:
            fail(f"{label}: a request failed without an injected fault: {e}")
        if o in ("timeout", "error"):
            fail(f"{label}: a request ended in {o}: {e}")


def gateway_faults(engine, cfg) -> None:
    """Phase 13 (b): chaos_smoke's fault schedule over the card's engine,
    4 workers: every request reaches one outcome, admitted = completed +
    shed + failed, the supervisor restarted every injected pump crash, a
    post-reset retry was replayed from the dedupe, and every failure is an
    injected fault."""
    r = chaos_run(engine, cfg, CHAOS_WORKERS, breaker=True)
    only_injected("gateway (b)", r)
    o = {k: r["outcomes"].count(k) for k in sorted(set(r["outcomes"]))}
    inj, c, sup = r["injected"], r["counters"], r["supervisor"]
    print(f"gateway (b): {CHAOS_REQUESTS} requests from {CHAOS_WORKERS} workers: {o}; "
          f"injected {inj}; supervisor {sup}; dedupe {r['dedupe']}; client {r['client']}; "
          f"server admitted {c.get('admitted', 0)} completed {c.get('completed', 0)} shed "
          f"{c.get('shed', 0)} failed {c.get('failed', 0)}")
    if sum(o.values()) != CHAOS_REQUESTS or None in r["outcomes"]:
        fail(f"gateway (b): outcomes {o} for {CHAOS_REQUESTS} requests")
    if c.get("admitted", 0) != c.get("completed", 0) + c.get("shed", 0) + c.get("failed", 0):
        fail(f"gateway (b): admitted != completed + shed + failed: {c}")
    if not inj.get("pump_crash") or sup["restarts"] != inj["pump_crash"] or sup["wedges"]:
        fail(f"gateway (b): supervisor {sup} for {inj.get('pump_crash', 0)} injected crashes")
    if not inj.get("forward_error") or o.get("failed", 0) > CHAOS_WORKERS * inj["forward_error"]:
        fail(f"gateway (b): {o.get('failed', 0)} failed for {inj.get('forward_error', 0)} "
             f"injected forward errors")
    if o.get("done", 0) <= CHAOS_REQUESTS // 2:
        fail(f"gateway (b): only {o.get('done', 0)} of {CHAOS_REQUESTS} served")
    if not inj.get("conn_reset") or not r["client"]["retries_conn"] or r["dedupe"]["replays"] < 1:
        fail(f"gateway (b): no post-reset retry was replayed from the dedupe: {r['dedupe']}")


def gateway_breaker(engine, cfg, reqs: list, served: list) -> None:
    """Phase 13 (c): with failure_threshold 3 and a persistently failing
    wrapper, 3 requests get a 500 and the rest a 503 without a forward;
    after the cooldown a probe closes the breaker, and its score is (a)'s
    for the same request (1e-5: another batch)."""
    import numpy as np

    from repro_torch.gateway import EnginePump, GatewayClient, GatewayError, GatewayServer

    wrapped = Breakable(engine)
    server = GatewayServer({"score": EnginePump(wrapped, "score")},
                           breaker_config={"failure_threshold": BREAKER_THRESHOLD,
                                           "cooldown_s": BREAKER_COOLDOWN_S}).start()
    try:
        client = GatewayClient(server.url, timeout_s=GW_JOIN_S, retries=0)
        wrapped.failing = True
        tail = []
        for hist, cand in reqs[1:BREAKER_REQUESTS + 1]:
            try:
                client.score(hist, cand, timeout_s=GW_JOIN_S)
                tail.append("done")
            except GatewayError as e:
                tail.append(e.kind)
        forwards = wrapped.forwards
        opened = server.breakers["score"].stats()
        wrapped.failing = False
        time.sleep(BREAKER_COOLDOWN_S + 0.05)
        probe = client.score(*reqs[0], timeout_s=GW_JOIN_S)
        closed = server.breakers["score"].stats()
    finally:
        server.stop()
    want = ["failed"] * BREAKER_THRESHOLD + ["unavailable"] * (BREAKER_REQUESTS - BREAKER_THRESHOLD)
    diff = float(np.abs(probe - served[0]).max())
    print(f"gateway (c): persistent fault: {tail}, {forwards} forwards; breaker open {opened}, "
          f"after the probe {closed}; probe vs (a) max abs diff {diff:.3e} "
          f"(bit for bit: {np.array_equal(probe, served[0])})")
    if tail != want or forwards != BREAKER_THRESHOLD:
        fail(f"gateway (c): {tail} with {forwards} forwards, want {want} with "
             f"{BREAKER_THRESHOLD}")
    if opened["state"] != "open" or opened["opened"] != 1 or closed["state"] != "closed":
        fail(f"gateway (c): breaker {opened} then {closed}")
    if not np.isfinite(probe).all() or not np.allclose(probe, served[0], rtol=1e-5, atol=1e-5):
        fail(f"gateway (c): the probe's scores differ from (a)'s by {diff:.3e}")


def gateway_determinism(engine, cfg) -> None:
    """Phase 13 (d): (b)'s schedule replayed twice with one worker and no
    breaker: equal injection logs and outcome sequences."""
    runs = [chaos_run(engine, cfg, 1, breaker=False) for _ in range(2)]
    for k, r in enumerate(runs):
        only_injected(f"gateway (d) run {k}", r)
    a, b = runs
    print(f"gateway (d): two runs of one worker: {len(a['log'])} and {len(b['log'])} "
          f"injections ({a['injected']}); outcomes "
          f"{ {k: a['outcomes'].count(k) for k in sorted(set(a['outcomes']))} }; "
          f"restarts {a['supervisor']['restarts']} and {b['supervisor']['restarts']}")
    if not a["log"] or a["log"] != b["log"]:
        first = next((x for x in zip(a["log"], b["log"]) if x[0] != x[1]), None)
        fail(f"gateway (d): the injection logs differ ({len(a['log'])} vs {len(b['log'])}; "
             f"first difference {first})")
    if a["outcomes"] != b["outcomes"]:
        fail("gateway (d): the outcome sequences differ")


def probe_hit_rate(engine, client, reqs: list) -> float:
    """Hit rate of ``reqs`` sent one at a time, from the counters' deltas."""
    keys = ("hot_hits", "cold_hits", "misses")
    before = [engine.metrics.counters.get(k, 0) for k in keys]
    outcomes, _, _, errors = drive(client, reqs, 1)
    all_served("gateway (e)", outcomes, errors)
    hot, cold, miss = (engine.metrics.counters.get(k, 0) - b for k, b in zip(keys, before))
    return (hot + cold) / (hot + cold + miss)


def gateway_warm_restart(dev, params, cfg) -> None:
    """Phase 13 (e): a gateway with a snapshot directory warms the card's
    cache on 512 requests, measures a 256-request probe's hit rate and
    drains (the snapshot is written); a fresh engine and gateway restore
    it, with the pinned and cold blocks on the card equal to the table's
    rows. The probe's hit rate is at most 1 point below the pre-restart
    rate (benchmarks/chaos_smoke.py's check) and at least a cold start's."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.gateway import EnginePump, GatewayClient, GatewayServer

    snapdir = os.path.join(ROOT, "build", f"gateway_snapshots_{os.getpid()}")
    shutil.rmtree(snapdir, ignore_errors=True)
    warm = gateway_requests(cfg, WARM_REQUESTS, seed=11)
    probe = gateway_requests(cfg, PROBE_REQUESTS, seed=12)
    rates = {}
    for label in ("pre", "post", "cold"):
        engine = mind_engine(dev, params, cfg)
        server = GatewayServer({"score": EnginePump(engine, "score")},
                               snapshot_dir=None if label == "cold" else snapdir)
        server.start()
        try:
            client = GatewayClient(server.url, timeout_s=GW_JOIN_S, retries=0)
            restores = engine.metrics.counters.get("snapshot_restores", 0)
            if label == "post":
                cache = engine.cache
                if cache.snapshot() != drained:
                    fail("gateway (e): the restored cache's state is not the drained one's")
                resident = np.flatnonzero(cache._slot_id >= 0)
                ids = torch.as_tensor(cache._slot_id[resident]).to(dev)
                cold = cache.cold_rows_device()
                if (restores != 1 or cold.device != dev or cache._hot_block.device != dev
                        or not torch.equal(cold[torch.as_tensor(resident).to(dev)],
                                           params["items"][ids])
                        or not torch.equal(cache._hot_block, params["items"][:cache.hot_size])):
                    fail(f"gateway (e): the restore ({restores} restores) did not rebuild the "
                         f"cache's blocks on {dev} from the table")
                print(f"gateway (e): restored {resident.size} resident cold rows and the "
                      f"{cache.hot_size} pinned rows on {cold.device}, equal to the table's")
            elif restores:
                fail(f"gateway (e) {label}: restored a snapshot")
            if label == "pre":
                outcomes, _, _, errors = drive(client, warm, 1)
                all_served("gateway (e) warm-up", outcomes, errors)
            rates[label] = probe_hit_rate(engine, client, probe)
        finally:
            server.stop()
        if label == "pre":
            path = os.path.join(snapdir, "score.cache.json")
            if not os.path.exists(path):
                fail("gateway (e): the drain wrote no snapshot")
            drained = engine.cache.snapshot()
        del engine, server
    shutil.rmtree(snapdir, ignore_errors=True)
    print(f"gateway (e): probe hit rate {rates['pre']:.6f} before the restart, "
          f"{rates['post']:.6f} restored ({(rates['post'] - rates['pre']) * 100:+.3f} pt), "
          f"{rates['cold']:.6f} cold-started")
    if rates["post"] < rates["pre"] - 0.01 or rates["post"] < rates["cold"]:
        fail(f"gateway (e): restored hit rate {rates['post']} against {rates['pre']} before "
             f"and {rates['cold']} cold")


def serve_cli_gateway(label: str, dev, engine: str, request) -> None:
    """``python -m repro_torch.launch.serve --engine <engine> --gateway
    127.0.0.1:0`` in a subprocess on the card (the reduced config:
    ``--smoke`` cannot be turned off) answers one request (``request(client)``
    returns its output and whether it is right), drains on SIGINT and
    exits 0."""
    import queue
    import re
    import signal
    import threading

    from repro_torch.gateway import GatewayClient

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", "--engine",
                             engine, "--gateway", "127.0.0.1:0"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    seen = []
    try:
        url, deadline = None, time.monotonic() + 300.0
        while url is None:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                fail(f"{label}: no [gateway] line within 300 s: {''.join(seen)}")
            if line is None:
                fail(f"{label}: the CLI exited {proc.wait()} before serving: {''.join(seen)}")
            seen.append(line)
            m = re.search(r"\[gateway\] .* on (http://\S+) ", line)
            url = m and m.group(1)
        if f"; {dev.type}" not in seen[-1]:
            fail(f"{label}: the CLI does not serve on the card: {seen[-1]}")
        client = GatewayClient(url, timeout_s=GW_JOIN_S, retries=0)
        got, ok = request(client)
        health = client.health()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60.0)
        reader.join(10.0)
        while not lines.empty():
            seen.append(lines.get_nowait() or "")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10.0)
    out = "".join(seen)
    print(f"{label}: the CLI served {got} on {url} (/healthz "
          f"{health['status']}), then exit {rc} on SIGINT; its output:\n{out.rstrip()}")
    if not ok or health["status"] != "ok":
        fail(f"{label}: served {got}, /healthz {health}")
    if rc != 0 or "[gateway] stopped: completed=1" not in out:
        fail(f"{label}: exit {rc}: {out}")


def gateway_cli(dev) -> None:
    """Phase 13 (f): the serve CLI's ``--engine recsys --gateway`` answers
    one /v1/score with two finite scores."""
    import numpy as np

    def score(client):
        scores = client.score([1, 2, 3], [4, 5], timeout_s=GW_JOIN_S)
        return scores.tolist(), scores.shape == (2,) and bool(np.isfinite(scores).all())

    serve_cli_gateway("gateway (f)", dev, "recsys", score)


def run_gateway(dev, params) -> dict:
    """Phase 13: the gateway and seeded chaos over MIND's serve engine at
    full width, sub-phases (a)-(f). Returns K1's entry of (a)."""
    from repro_torch.configs.base import get_arch

    cfg = get_arch("mind")
    entry, engine, reqs, served = phase("13a (gateway, healthy serving)", gateway_healthy, dev,
                                        params, cfg)
    phase("13b (gateway, faults)", gateway_faults, engine, cfg)
    phase("13c (gateway, breaker)", gateway_breaker, engine, cfg, reqs, served)
    phase("13d (gateway, determinism)", gateway_determinism, engine, cfg)
    del engine
    phase("13e (gateway, warm restart)", gateway_warm_restart, dev, params, cfg)
    phase("13f (gateway, serve CLI)", gateway_cli, dev)
    return entry


# ---------------------------------------------------------------------------
# phase 14: LM serving (nn.transformer, LMServeEngine, lm_loop, --engine lm)
# ---------------------------------------------------------------------------
def kernel_counters() -> tuple:
    """K1's, K2's, K3's, the segment-min, the relaxation's, the segment-sum,
    the GAT attention, the segment-reduce and the softmax-aggregation
    kernel's wrappers: each counts its launches on the card."""
    from repro_torch.kernels.embedding_bag.embedding_bag import hot_bag_hot_part
    from repro_torch.kernels.gat_attend.gat_attend import gat_attend
    from repro_torch.kernels.hot_gather.hot_gather import (hot_gather_hot_part,
                                                           hot_gather_segment_sum)
    from repro_torch.kernels.segment_min.relax import relax_min
    from repro_torch.kernels.segment_min.segment_min import segment_min
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_stats
    from repro_torch.kernels.segment_sum.segment_sum import segment_sum
    from repro_torch.kernels.softmax_aggr.softmax_aggr import softmax_aggr

    return (hot_gather_hot_part, hot_gather_segment_sum, hot_bag_hot_part, segment_min,
            relax_min, segment_sum, gat_attend, segment_stats, softmax_aggr)


def lm_close(label: str, got, want, tol: dict) -> float:
    """Max abs difference of two float tensors (``got`` on the card), after
    checking both are finite and within ``tol``."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all() and torch.isfinite(want).all()
              and torch.allclose(got, want, **tol))
    print(f"{label}: max abs diff {err:.4e} (rtol {tol['rtol']}, atol {tol['atol']}) "
          f"on values up to {float(want.abs().max()):.3f}")
    if not ok:
        fail(f"{label}: outside rtol {tol['rtol']} atol {tol['atol']} (max abs diff {err})")
    return err


def lm_layers(params, n: int):
    """The first ``n`` layers of an LM's parameters (views)."""
    from repro_torch.train.tree import tree_map

    return dict(params, layers=tree_map(lambda a: a[:n], params["layers"]))


def lm_weight_bytes(params) -> tuple[float, float]:
    """(bytes a decode step moves as the JAX package's ``dense`` computes
    it, the same with bfloat16 weights held): every layer matrix read in
    float32, written in bfloat16 and read again (8 bytes a weight; 2 if
    held), the float32 LM head read once (4; 2 if held), the norms'
    float32 read; the embedding rows and the small KV cache left out."""
    from repro_torch.train.tree import tree_leaves

    cast = held = 0.0
    for leaf in tree_leaves(params["layers"]):
        n = leaf.numel()
        cast += (8 if leaf.dim() > 2 else 4) * n
        held += (2 if leaf.dim() > 2 else 4) * n
    head = params["lm_head"]["w"].numel()
    return cast + 4 * head, held + 2 * head


def profile_top(fn, top: int = 6, width: int = 60) -> tuple[float, float, str]:
    """(device busy ms, host wall ms, the kernel count and the top kernels
    by device time) of ``fn`` under torch.profiler, in a window padded by
    ``spin_pad``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the card's activity only: a batch launches ~90,000 kernels, and host
    # events beside them take the profiler most of a minute to sort
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spin_pad()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        spin_pad()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "spin_kernel" not in e.key),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    tops = (f"{sum(e.count for e in kernels)} kernels; "
            + "; ".join(f"{e.key[:width]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                        for e in kernels[:top]))
    return busy, wall, tops


def lm_prompts(vocab: int, n: int, length: int, seed: int):
    import numpy as np

    from repro_torch.data.pipeline import zipf_ids

    return zipf_ids(np.random.default_rng(seed), (n, length), vocab)


def lm_serve_full(dev):
    """Phase 14 (a): minitron-8b at its published width and depth (32
    layers, d 4096, 32 heads, 8 KV heads, d_ff 16,384, vocab 256,000; float32
    weights drawn on the card): lm_loop(smoke=False) at the serve CLI's
    defaults (16 requests, batches of 8, prefill 64, decode 32), then
    LMServeEngine(smoke=False) serving 16 queued requests, its prefill and
    decode step timed by CUDA events, one batch's busy share under
    torch.profiler, and peak memory. Returns the engine."""
    import numpy as np
    import torch

    from repro_torch.nn import transformer as tfm
    from repro_torch.serve.engine import LMServeEngine, lm_loop
    from repro_torch.serve.scheduler import SchedulerConfig
    from repro_torch.train.tree import tree_leaves

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    stats = lm_loop(arch=LM_ARCH, smoke=False, requests=LM_REQUESTS, batch=LM_BATCH,
                    prefill=LM_PREFILL, decode=LM_DECODE, device=dev)
    print(f"lm (a): lm_loop {LM_ARCH} at full width: {stats}; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = LMServeEngine(arch=LM_ARCH, smoke=False, prefill=LM_PREFILL, decode=LM_DECODE,
                           sched_config=SchedulerConfig(max_batch=LM_BATCH, max_queue=64),
                           device=dev)
    cfg, params = engine.cfg, engine.params
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.synchronize()
    print(f"lm (a): {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_kv} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params} parameters "
          f"(param_count {cfg.param_count()}), {n_params * 4 / 1e9:.2f} GB float32, drawn on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    # param_count leaves out ln_f's gain (d_model entries)
    if n_params != cfg.param_count() + cfg.d_model:
        fail(f"lm (a): {n_params} parameters against param_count {cfg.param_count()}")
    engine.warmup()
    prompts = lm_prompts(cfg.vocab, LM_REQUESTS, LM_PREFILL, seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    reqs = [engine.submit({"tokens": p}) for p in prompts]
    engine.run_until_idle()
    wall = time.perf_counter() - t0
    outs = [r.result for r in reqs]
    if not all(o is not None and o.shape == (LM_DECODE,) and 0 <= o.min() and o.max() < cfg.vocab
               for o in outs):
        fail(f"lm (a): engine results {[None if o is None else o.shape for o in outs]}")
    served = engine.metrics.counters["tokens_generated"]
    print(f"lm (a): LMServeEngine served {len(reqs)} requests ({served} tokens) in {wall:.3f} s: "
          f"{served / wall:.1f} tok/s; first request's tokens {outs[0][:8].tolist()}...")

    tokens = torch.from_numpy(prompts[:LM_BATCH]).to(dev)
    max_len = LM_PREFILL + LM_DECODE
    prefill_ms = time_ms(lambda: tfm.prefill(params, cfg, tokens, max_len=max_len), reps=5,
                         warmup=1)
    _, cache = tfm.prefill(params, cfg, tokens, max_len=max_len)
    tok = torch.zeros(LM_BATCH, dtype=torch.long, device=dev)
    # each call writes position LM_PREFILL of the same cache: one step's work
    decode_ms = time_ms(lambda: tfm.decode_step(params, cfg, cache, tok), reps=10, warmup=2)
    cast_bytes, held_bytes = lm_weight_bytes(params)
    print(f"lm (a): batch {LM_BATCH}: prefill of {LM_PREFILL} tokens {prefill_ms:.3f} ms, "
          f"decode {decode_ms:.3f} ms a step (CUDA events); a decode step's weight traffic "
          f"{cast_bytes / 1e9:.2f} GB as dense casts the float32 weights (bound "
          f"{cast_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
          f"{held_bytes / 1e9:.2f} GB with bfloat16 weights held (bound "
          f"{held_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms)")
    # a batch is one prefill and LM_DECODE - 1 decode steps, each over the
    # whole cache: the same kernels every step. So its busy time is the
    # profiled prefill's plus LM_DECODE - 1 profiled steps' (the mean of 3),
    # over the batch's wall time without the profiler (a whole batch
    # profiled, ~90,000 kernels, took the profiler 37 s to sort)
    payloads = [{"tokens": p} for p in prompts[:LM_BATCH]]
    engine.forward(payloads)
    t0 = time.perf_counter()
    engine.forward(payloads)
    batch_ms = (time.perf_counter() - t0) * 1e3
    t_prof = time.perf_counter()
    busy_p, wall_p, tops_p = profile_top(
        lambda: tfm.prefill(params, cfg, tokens, max_len=max_len))
    busy_d, wall_d, tops_d = profile_top(
        lambda: [tfm.decode_step(params, cfg, cache, tok) for _ in range(3)])
    busy = busy_p + (LM_DECODE - 1) * busy_d / 3
    print(f"lm (a): one batch of {LM_BATCH}: {batch_ms:.1f} ms wall, device busy {busy:.1f} ms "
          f"({busy / batch_ms:.1%} busy): prefill busy {busy_p:.2f} ms (profiled wall "
          f"{wall_p:.2f}), a decode step busy {busy_d / 3:.2f} ms (profiled wall "
          f"{wall_d / 3:.2f}); prefill's {tops_p}; 3 decode steps' {tops_d}")
    print(f"lm (a): peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB while serving; "
          f"(a) took {time.perf_counter() - t_start:.1f} s, the profiled windows "
          f"{time.perf_counter() - t_prof:.1f} s of it")
    if not np.isfinite([prefill_ms, decode_ms]).all():
        fail("lm (a): timings")
    return engine


def lm_teacher_forcing(engine) -> None:
    """Phase 14 (b): tests/test_nn.py::test_decode_matches_forward at full
    width and depth: prefill over 8 tokens and 4 decode steps against
    forward's logits at the same positions. That test's tolerance (rtol
    0.06, atol 5e-2) is for logits of ~0.6 after 2 layers; here they reach
    ~6 after 32, and the card's bfloat16 products round differently at
    each shape (cuBLAS picks its kernel by shape). So the run measures that
    floor too: forward over the first t + 1 tokens against forward over 13
    at each position t, the same function at another length (two lengths
    may share their kernels and agree bit for bit; the floor is the
    largest difference over the five). Each step passes within the test's
    tolerance, or within twice the floor."""
    import torch

    from repro_torch.nn import transformer as tfm

    cfg, params = engine.cfg, engine.params
    tokens = torch.from_numpy(lm_prompts(cfg.vocab, 2, 13, seed=1)).to(engine.device)
    full = tfm.forward(params, cfg, tokens)[0].float()
    floors = [float((tfm.forward(params, cfg, tokens[:, :t + 1])[0][:, t].float()
                     - full[:, t]).abs().max()) for t in range(7, 12)]
    floor = max(floors)
    print(f"lm (b): floor, forward over t + 1 tokens vs 13 at t = 7..11: "
          f"{[f'{f:.4e}' for f in floors]}")
    logits, cache = tfm.prefill(params, cfg, tokens[:, :8], max_len=16)
    steps = [("prefill(8)", 7, logits)]
    for t in range(8, 12):
        logits, cache = tfm.decode_step(params, cfg, cache, tokens[:, t])
        steps.append(("decode step", t, logits))
    for name, t, got in steps:
        got, want = got.float(), full[:, t]
        err = float((got - want).abs().max())
        in_tol = bool(torch.allclose(got, want, **LM_TF_TOL))
        print(f"lm (b): {name} at position {t} vs forward: max abs diff {err:.4e} on logits up "
              f"to {float(want.abs().max()):.3f}; within rtol {LM_TF_TOL['rtol']} atol "
              f"{LM_TF_TOL['atol']}: {in_tol}; within twice the floor {floor:.4e}: "
              f"{err <= 2 * floor}")
        if not torch.isfinite(got).all() or not (in_tol or err <= 2 * floor):
            fail(f"lm (b): {name} at position {t}: max abs diff {err} against floor {floor}")


def greedy_agrees(label: str, card_logits, cpu_logits, tol: dict) -> None:
    """The card's greedy tokens equal the CPU's wherever the CPU's top-1 /
    top-2 margin exceeds twice the logit tolerance at the top logit."""
    import torch

    cpu_logits = cpu_logits.float()
    top2 = torch.topk(cpu_logits, 2, dim=-1).values
    limit = 2 * (tol["atol"] + tol["rtol"] * top2[..., 0].abs())
    clear = (top2[..., 0] - top2[..., 1]) > limit
    same = card_logits.float().cpu().argmax(-1) == cpu_logits.argmax(-1)
    print(f"{label}: greedy tokens equal at {int(same.sum())} of {same.numel()} positions; "
          f"{int(clear.sum())} positions have a clear margin, all of them equal: "
          f"{bool(same[clear].all())}")
    if not bool(same[clear].all()):
        fail(f"{label}: a greedy token differs where the margin is clear")


def lm_card_vs_cpu(label: str, cfg, params, n_layers: int, dev, routing=None):
    """``params`` cut to ``n_layers`` layers at full width on the card
    against the same weights on the CPU: 2 prompts of 64 tokens, the
    prefill logits and 4 decode steps' logits (fed the CPU's greedy tokens)
    within LM_CPU_REL of the largest CPU logit, the greedy tokens as
    ``greedy_agrees`` says.
    ``routing``, for a MoE config, records both devices' expert choices:
    a sequence the two route differently is left out of the logits check
    (its tokens may go to other experts) and counted. Returns the cut
    config, the card's and the CPU's parameters and the prompts."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.nn import transformer as tfm
    from repro_torch.train.tree import tree_map

    cut = dataclasses.replace(cfg, n_layers=n_layers)
    card = lm_layers(params, n_layers)
    t0 = time.perf_counter()
    cpu = tree_map(lambda t: t.cpu(), card)
    tokens = torch.from_numpy(lm_prompts(cfg.vocab, 2, 64, seed=2))
    max_len = 64 + 4
    steps = []
    with routing or contextlib.nullcontext():
        cpu_logits, cpu_cache = tfm.prefill(cpu, cut, tokens, max_len=max_len)
        card_logits, card_cache = tfm.prefill(card, cut, tokens.to(dev), max_len=max_len)
        steps.append(("prefill", card_logits, cpu_logits))
        for t in range(4):
            fed = cpu_logits.argmax(-1)
            cpu_logits, cpu_cache = tfm.decode_step(cpu, cut, cpu_cache, fed)
            card_logits, card_cache = tfm.decode_step(card, cut, card_cache, fed.to(dev))
            steps.append((f"decode {t}", card_logits, cpu_logits))
    rows = routing.agree(2, n_layers) if routing else torch.ones(2, dtype=torch.bool)
    print(f"{label}: {n_layers} of {cfg.n_layers} layers at full width, CPU copy and run "
          f"{time.perf_counter() - t0:.1f} s; sequences routed alike on both: "
          f"{int(rows.sum())} of 2")
    for name, got, want in steps:
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            fail(f"{label}: {name} logits are not finite")
        if rows.any():
            tol = dict(rtol=0.0, atol=LM_CPU_REL * float(want[rows].abs().max()))
            lm_close(f"{label}: {name} logits, card vs CPU", got[rows.to(got.device)],
                     want[rows], tol)
            greedy_agrees(f"{label}: {name}", got[rows.to(got.device)], want[rows], tol)
    return cut, card, cpu, tokens


def kept_picks(ids, n_experts: int, cap: int):
    """(T, k) expert ids -> which picks ``nn.layers.moe`` keeps: a pick's
    rank among the earlier picks of its expert, in token order, below
    ``cap``."""
    import torch
    import torch.nn.functional as F

    flat = ids.reshape(-1)
    onehot = F.one_hot(flat, n_experts)
    ranks = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    return (ranks < cap).reshape(ids.shape)


def lm_moe_layers_card_vs_cpu(label: str, cfg, card, cpu, tokens, dev) -> None:
    """A MoE model card against CPU layer by layer: each layer gets the
    CPU's hidden states on both devices, so a token the two route apart
    cannot carry its difference on. Its output (B, S, d) is held, token by
    token, where both devices chose the same experts and kept the same
    picks, within rtol 1e-2 and 1e-2 of the largest CPU entry (one layer's
    bfloat16 products); at least 90% of the tokens must be routed alike."""
    import numpy as np
    import torch

    from repro_torch.nn import transformer as tfm

    b, s = tokens.shape
    pos = torch.arange(s).expand(b, s)
    x = tfm._embed(cpu, tokens)
    moe = cfg.moe
    cap = int(np.ceil(b * s * moe.top_k / moe.n_experts * moe.capacity_factor))
    for i in range(cfg.n_layers):
        with MoERouting() as routing:
            want, _, _ = tfm._layer_fwd(cfg, tfm.layer_params(cpu, i), x, pos)
            got, _, _ = tfm._layer_fwd(cfg, tfm.layer_params(card, i), x.to(dev), pos.to(dev))
        ids_cpu, ids_card = routing.calls
        alike = ((ids_cpu == ids_card).all(1)
                 & (kept_picks(ids_cpu, moe.n_experts, cap)
                    == kept_picks(ids_card, moe.n_experts, cap)).all(1)).reshape(b, s)
        share = float(alike.float().mean())
        print(f"{label}: layer {i} on the CPU's input: {int(alike.sum())} of {b * s} tokens "
              f"routed alike ({share:.1%})")
        tol = dict(rtol=1e-2, atol=1e-2 * float(want.float().abs().max()))
        lm_close(f"{label}: layer {i}'s output over those tokens, card vs CPU",
                 got[alike.to(dev)], want[alike], tol)
        if share < 0.9:
            fail(f"{label}: layer {i}: only {share:.1%} of tokens routed alike")
        x = want


class MoERouting:
    """Records the expert choices of every ``nn.layers.moe`` call while
    active. ``lm_card_vs_cpu`` runs each step on the CPU, then on the card,
    so the calls come in blocks of ``n_layers`` CPU calls and ``n_layers``
    card calls, and ``agree`` compares them call by call. A token routed
    differently sets its own and every later sequence apart (the capacity
    ranks follow the token order)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.nn import layers

        self._moe = layers.moe

        def recording(params, x, top_k, **kw):
            probs = torch.softmax(layers.dense(params["router"], x, torch.float32), -1)
            self.calls.append(layers.top_k_experts(probs, top_k)[1].cpu())
            return self._moe(params, x, top_k, **kw)

        layers.moe = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import layers

        layers.moe = self._moe
        return False

    def agree(self, batch: int, n_layers: int):
        import torch

        blocks = [self.calls[i:i + n_layers] for i in range(0, len(self.calls), n_layers)]
        if len(blocks) % 2 or any(len(b) != n_layers for b in blocks):
            fail(f"MoE routing: {len(self.calls)} calls, not CPU/card blocks of {n_layers}")
        cpu = [c for b in blocks[0::2] for c in b]
        card = [c for b in blocks[1::2] for c in b]
        ok = torch.ones(batch, dtype=torch.bool)
        for a, b in zip(cpu, card):
            diff = torch.nonzero((a != b).any(dim=1)).flatten()
            if diff.numel():
                ok[int(diff[0]) // (a.shape[0] // batch):] = False
        return ok


def lm_prefill_32k(engine) -> None:
    """Phase 14 (d): LM_SHAPES["prefill_32k"] cut from 32 sequences to 1 (the
    KV cache of 32 would alone take 137 GB): one sequence of 32,768 tokens
    through prefill at full width and depth, its time and peak memory, the
    logits finite; then layer 0's chunked attention at 4,096 tokens against
    the same call in one chunk (q_chunk = kv_chunk = 4,096; rtol = atol =
    1e-2, tests/test_torch_lm.py's bound on one bfloat16 layer)."""
    import torch

    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as tfm

    cfg, params, dev = engine.cfg, engine.params, engine.device
    seq = LM_SHAPES["prefill_32k"].seq_len
    tokens = torch.from_numpy(lm_prompts(cfg.vocab, 1, seq, seed=3)).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    logits, cache = tfm.prefill(params, cfg, tokens)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"lm (d): prefill of {seq} tokens at batch 1 (of prefill_32k's "
          f"{LM_SHAPES['prefill_32k'].global_batch}): {ms:.1f} ms (CUDA events, first call at "
          f"this shape), {seq / ms * 1e3:.0f} tokens/s; peak {peak / 2**30:.2f} GiB "
          f"({(peak - base) / 2**30:.2f} GiB above the weights), KV cache "
          f"{2 * cache.k.numel() * cache.k.element_size() / 2**30:.2f} GiB, cache length "
          f"{cache.length}")
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all() or cache.length != seq:
        fail(f"lm (d): logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    del logits, cache
    n = 4096
    lp = tfm.layer_params(params, 0)
    x = tfm._norm(cfg, lp["ln1"], tfm._embed(params, tokens[:, :n]))
    pos = torch.arange(n, device=dev)[None]
    q = L.rope(L.dense(lp["attn"]["wq"], x).reshape(1, n, cfg.n_heads, cfg.head_dim), pos)
    k = L.rope(L.dense(lp["attn"]["wk"], x).reshape(1, n, cfg.n_kv, cfg.head_dim), pos)
    v = L.dense(lp["attn"]["wv"], x).reshape(1, n, cfg.n_kv, cfg.head_dim)
    chunked = L.attention(q, k, v)
    one = L.attention(q, k, v, q_chunk=n, kv_chunk=n)
    lm_close(f"lm (d): layer 0's attention at {n} tokens, 8 x 4 chunks vs one chunk", chunked,
             one, dict(rtol=1e-2, atol=1e-2))


def lm_moe(dev) -> None:
    """Phase 14 (e): phi3.5-moe-42b-a6.6b at its published width, 4 of 32
    layers (16 experts, top-2, d 4096, d_ff 6,400; its 32 layers in
    float32 would not fit one card): one batch of 8 x 64 tokens and 8
    greedy decode steps on the card, finite; then 2 of those layers on the
    card against the CPU as in (c), end to end over the sequences both
    devices route alike (a token routed apart moves its sequence past any
    tolerance), and layer by layer over the tokens both route alike."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.nn import transformer as tfm

    full = get_arch(LM_MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=LM_MOE_LAYERS)
    t0 = time.perf_counter()
    params = tfm.init(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    torch.cuda.synchronize()
    print(f"lm (e): {cfg.name} at {cfg.n_layers} of {full.n_layers} layers: "
          f"{cfg.param_count()} parameters ({cfg.param_count() * 4 / 1e9:.2f} GB float32), "
          f"drawn in {time.perf_counter() - t0:.1f} s")
    tokens = torch.from_numpy(lm_prompts(cfg.vocab, LM_BATCH, LM_PREFILL, seed=4)).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    logits, cache = tfm.prefill(params, cfg, tokens, max_len=LM_PREFILL + 8)
    out = [logits.argmax(-1)]
    finite = bool(torch.isfinite(logits).all())
    for _ in range(8):
        logits, cache = tfm.decode_step(params, cfg, cache, out[-1])
        finite &= bool(torch.isfinite(logits).all())
        out.append(logits.argmax(-1))
    end.record()
    end.synchronize()
    print(f"lm (e): prefill {LM_BATCH} x {LM_PREFILL} and 8 decode steps in "
          f"{start.elapsed_time(end):.1f} ms, logits finite {finite}, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; tokens of row 0 "
          f"{[int(t[0]) for t in out]}")
    if not finite:
        fail("lm (e): non-finite logits")
    cut, card, cpu, tokens = lm_card_vs_cpu("lm (e)", cfg, params, LM_CPU_LAYERS, dev,
                                            MoERouting())
    lm_moe_layers_card_vs_cpu("lm (e)", cut, card, cpu, tokens, dev)


def lm_cli(dev) -> None:
    """Phase 14 (f): ``python -m repro_torch.launch.serve --engine lm`` on
    the card (the reduced starcoder2-7b at the CLI's defaults), then the
    same with ``--gateway`` answering one /v1/generate."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--engine", "lm"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    print(f"lm (f): --engine lm exit {proc.returncode}: {proc.stdout.strip()}")
    if proc.returncode != 0 or "[serve] 16 requests, 512 tokens" not in proc.stdout:
        fail(f"lm (f): --engine lm: {proc.stdout} {proc.stderr}")

    def generate(client):
        toks = client.generate([1, 2, 3], timeout_s=GW_JOIN_S)
        return toks, len(toks) == 32 and all(isinstance(t, int) for t in toks)

    serve_cli_gateway("lm (f)", dev, "lm", generate)


def run_lm_serving(dev) -> None:
    """Phase 14: LM serving, which launches no kernel of the port (the JAX
    package's transformer reaches no pallas_call): K1's, K2's and K3's
    launch counts are 0 at its start and still 0 at its end."""
    import torch

    torch.empty(0, device=dev)   # the card's context, before its memory stats are read
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    engine = phase("14a (minitron-8b served at full width)", lm_serve_full, dev)
    phase("14b (teacher forcing at full depth)", lm_teacher_forcing, engine)
    phase("14c (minitron-8b, card vs CPU at 2 layers)", lm_card_vs_cpu, "lm (c)", engine.cfg,
          engine.params, LM_CPU_LAYERS, dev)
    phase("14d (prefill_32k at batch 1)", lm_prefill_32k, engine)
    del engine
    torch.cuda.empty_cache()
    phase("14e (phi3.5-MoE at 4 of 32 layers)", lm_moe, dev)
    torch.cuda.empty_cache()
    phase("14f (serve CLI --engine lm)", lm_cli, dev)
    launched = {c.__name__: c.launches for c in counters}
    print(f"LM serving: kernel launches {launched}")
    if any(launched.values()):
        fail(f"LM serving launched a kernel: {launched}")


# ---------------------------------------------------------------------------
# phase 15: LM training (loss_fn, lm_train_step, donation, Trainer, the CLI)
# ---------------------------------------------------------------------------
def lm_train_cfg(n_layers: int):
    import dataclasses

    from repro_torch.configs.base import get_arch

    return dataclasses.replace(get_arch(LM_ARCH), n_layers=n_layers)


def lm_train_full(dev) -> None:
    """Phase 15 (a): minitron-8b at its published width, LM_TRAIN_LAYERS of
    32 layers (per-layer remat, as its config has it), train_4k's 4,096
    positions at a global batch of LM_TRAIN_BATCH: launch.steps.
    lm_train_step's donated step (for_arch: AdamW, float32 moments) over
    seeded lm_batch batches, one warm-up step and LM_TRAIN_TIMED timed by
    CUDA events. Prints ms a step, tokens/s, MFU (roofline.model_flops_for
    over the step over roofline.PEAK_FLOPS), analytic_lm_terms' bound and
    the step's fraction of it, peak memory against the state's count, and
    one microbatch's busy share and top kernels under torch.profiler."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch import roofline
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.nn import transformer as tfm
    from repro_torch.train.optimizer import for_arch
    from repro_torch.train.trainer import batch_to, value_and_grad

    cfg = lm_train_cfg(LM_TRAIN_LAYERS)
    shape = dataclasses.replace(LM_SHAPES["train_4k"], global_batch=LM_TRAIN_BATCH)
    n, opt = cfg.param_count(), for_arch(cfg)
    mb = max(min(cfg.microbatches, shape.global_batch), 1)
    print(f"lm train (a): {cfg.name} at {cfg.n_layers} of 32 layers (d {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}), {n:,} parameters; {opt.name} with "
          f"{opt.moment_dtype} moments, donated; seq {shape.seq_len}, global batch "
          f"{shape.global_batch} in {mb} microbatches; remat {cfg.remat}; parameters, moments "
          f"and the gradient sum {16 * n / 1e9:.2f} GB ({16 * n / 2**30:.2f} GiB)")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    opt_init, step = lm_train_step(cfg, shape, device=dev)
    state = opt_init(params)
    rng = np.random.default_rng(15)
    batches = [lm_batch(rng, cfg, shape.global_batch, shape.seq_len)
               for _ in range(1 + LM_TRAIN_TIMED)]
    torch.cuda.synchronize()
    print(f"lm train (a): weights drawn on the card and {len(batches)} batches on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    losses, ms, wall = [], [], []
    for i, b in enumerate(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        params, state, metrics = step(params, state, b)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        if i:
            wall.append((time.perf_counter() - t0) * 1e3)
            ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated(dev)
    step_s = statistics.median(ms) / 1e3
    tokens = shape.global_batch * shape.seq_len
    flops = roofline.model_flops_for(cfg, shape)
    terms = roofline.analytic_lm_terms(cfg, shape, num_devices=1, n_model=1)
    t_ops = terms["flops_per_dev"] / roofline.PEAK_FLOPS
    t_bytes = terms["hbm_bytes_per_dev"] / roofline.HBM_BW
    bound_s = max(t_ops, t_bytes)
    print(f"lm train (a): step ms (CUDA events) {[round(x, 3) for x in ms]}, median "
          f"{step_s * 1e3:.3f} (host wall {[round(x, 3) for x in wall]}); {tokens / step_s:,.1f} "
          f"tokens/s; MFU {flops / step_s / roofline.PEAK_FLOPS:.4f} (model_flops_for "
          f"{flops:.4e} FLOP over the step at {roofline.PEAK_FLOPS:.4g} FLOP/s); "
          f"analytic_lm_terms: {terms['flops_per_dev']:.4e} FLOP ({t_ops * 1e3:.3f} ms), "
          f"{terms['hbm_bytes_per_dev']:.4e} B ({t_bytes * 1e3:.3f} ms), bound {bound_s * 1e3:.3f} "
          f"ms by {'operations' if t_ops >= t_bytes else 'bytes'}, the step at "
          f"{bound_s / step_s:.4f} of it; peak {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} "
          f"above the earlier phases' tensors; the state {16 * n / 2**30:.2f} GiB, the card "
          f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f} GiB); losses "
          f"{[round(x, 6) for x in losses]}")
    if not np.isfinite(losses).all():
        fail(f"lm train (a): losses {losses}")
    part = batch_to({k: v[:shape.global_batch // mb] for k, v in batches[0].items()}, dev)
    busy, wall_p, tops = profile_top(lambda: value_and_grad(tfm.loss_fn, params, cfg, part),
                                     top=10, width=160)
    print(f"lm train (a): one microbatch's loss and gradients under torch.profiler: wall "
          f"{wall_p:.3f} ms, device busy {busy:.3f} ms (share {busy / wall_p:.4f}); {tops}")


def lm_train_card_vs_cpu(dev) -> None:
    """Phase 15 (b): minitron-8b at its published width, LM_TRAIN_CPU_LAYERS
    layer, on the card against the same weights on the CPU: the loss and
    every gradient of one microbatch of LM_TRAIN_CPU_BATCH x
    LM_TRAIN_CPU_SEQ positions, within tests/test_torch_lm_train.py's
    bounds of the port against the JAX package (LM_TRAIN_LOSS_ATOL, each
    leaf within LM_TRAIN_GRAD_REL of its largest entry). Beside them it
    prints how far the CPU's own gradients move when the embedding table is
    nudged by 1e-7 relative (an ulp of noise), as phase 11 (a) does."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import lm_batch
    from repro_torch.nn import transformer as tfm
    from repro_torch.train.trainer import batch_to, value_and_grad
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = lm_train_cfg(LM_TRAIN_CPU_LAYERS)
    cpu = torch.device("cpu")
    card = tfm.init(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    host = tree_map(lambda t: t.cpu(), card)
    b = lm_batch(np.random.default_rng(16), cfg, LM_TRAIN_CPU_BATCH, LM_TRAIN_CPU_SEQ)
    loss_d, grads_d = value_and_grad(tfm.loss_fn, card, cfg, batch_to(b, dev))
    t0 = time.perf_counter()
    loss_c, grads_c = value_and_grad(tfm.loss_fn, host, cfg, batch_to(b, cpu))
    cpu_s = time.perf_counter() - t0
    rel = leaf_relative(tree_errors(grads_d, grads_c), grads_c)
    del grads_d
    # the rows the batch reads, nudged: the others do not reach the loss
    rows = torch.from_numpy(np.unique(b["tokens"])).long()
    embed = host["embed"].clone()
    embed[rows] *= 1 + 1e-7 * torch.randn((len(rows), cfg.d_model),
                                          generator=torch.Generator().manual_seed(17))
    loss_n, grads_n = value_and_grad(tfm.loss_fn, dict(host, embed=embed), cfg,
                                     batch_to(b, cpu))
    noise = max(leaf_relative(tree_errors(grads_n, grads_c), grads_c))
    finite = bool(torch.isfinite(loss_d)) and all(bool(torch.isfinite(g).all())
                                                  for g in tree_leaves(grads_c))
    err = abs(float(loss_d) - float(loss_c))
    print(f"lm train (b): {cfg.n_layers} layer at full width, {LM_TRAIN_CPU_BATCH} x "
          f"{LM_TRAIN_CPU_SEQ} positions: loss card {float(loss_d):.6f} CPU {float(loss_c):.6f} "
          f"(diff {err:.3e}, bound {LM_TRAIN_LOSS_ATOL}); gradients: largest max abs diff over "
          f"the leaf's largest entry {max(rel):.3e} (bound {LM_TRAIN_GRAD_REL}; per leaf "
          f"{[f'{x:.2e}' for x in rel]}); the CPU's own under 1e-7 relative noise on the "
          f"embedding: loss {abs(float(loss_n) - float(loss_c)):.3e}, gradients {noise:.3e}; "
          f"the CPU's loss and gradients took {cpu_s:.1f} s")
    if not finite or err > LM_TRAIN_LOSS_ATOL or max(rel) > LM_TRAIN_GRAD_REL:
        fail("lm train (b): the card differs from the CPU")


def lm_train_donation(dev) -> None:
    """Phase 15 (c): on the card, under torch.use_deterministic_algorithms,
    Trainer.fit with 2 microbatches on examples/train_lm.py's minitron
    width at 2 layers (4 x 256 positions a step), donated against not donated, 3 steps each for SGD,
    AdamW with float32 and with bfloat16 moments, and Adafactor: the same
    history and final state bit for bit; then a donated fit of 6 steps with
    checkpoints every 2 (under build/) and failures at steps 3 and 4:
    two restarts, and a clean fit's history and state bit for bit."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import torch

    from repro_torch.configs.base import LMShape, get_arch, reduced
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.nn import transformer as tfm
    from repro_torch.train.ft import FailureInjector
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import tree_leaves

    cfg = dataclasses.replace(reduced(get_arch(LM_ARCH)), **LM_TRAIN_SMALL)
    batch_fn = make_batch_fn("lm", cfg, LMShape("t", "train", 256, 4), seed=5)
    opts = {"sgd": OptConfig(name="sgd", lr=1e-2), "adamw f32": OptConfig(lr=1e-3),
            "adamw bf16": OptConfig(lr=1e-3, moment_dtype="bfloat16"),
            "adafactor": OptConfig(name="adafactor", lr=1e-2)}

    def fit(opt, donate: bool, steps: int = 3, injector=None, **ckpt):
        tr = Trainer(lambda p, b: tfm.loss_fn(p, cfg, b),
                     lambda: tfm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                                      device=dev),
                     opt, TrainerConfig(num_steps=steps, microbatches=2, log_every=1,
                                        donate=donate, **ckpt), device=dev)
        with contextlib.redirect_stdout(io.StringIO()):
            return tr, tr.fit(batch_fn, injector=injector)

    def bits(a, b) -> bool:
        return all(x.dtype == y.dtype and same_bits(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    def runs():
        out = {}
        for name, opt in opts.items():
            (d_tr, d_state), (u_tr, u_state) = fit(opt, True), fit(opt, False)
            out[name] = (d_tr.history == u_tr.history and bits(d_state, u_state),
                         d_tr.history[-1]["loss"])
        clean, clean_state = fit(opts["adamw f32"], True, steps=6)
        scratch = os.path.join(ROOT, "build")
        os.makedirs(scratch, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            faulty, state = fit(opts["adamw f32"], True, steps=6, ckpt_dir=d, ckpt_every=2,
                                injector=FailureInjector(fail_at=(3, 4)))
        replay = ({h["step"]: h for h in faulty.history} == {h["step"]: h for h in clean.history}
                  and bits(state, clean_state))
        return out, faulty.restarts, replay

    (out, restarts, replay), refused = deterministic(runs)
    print(f"lm train (c): {cfg.param_count():,} parameters; donated vs not, 3 steps "
          f"(deterministic {'no: ' + refused if refused else 'yes'}): "
          + "; ".join(f"{k} {'the same bits' if same else 'DIFFERENT'} (loss {l:.6f})"
                      for k, (same, l) in out.items())
          + f"; a donated fit with failures at steps 3 and 4: {restarts} restarts, "
          f"{'the clean fit bit for bit' if replay else 'DIFFERENT from the clean fit'}")
    if not all(same for same, _ in out.values()) or restarts != 2 or not replay:
        fail("lm train (c): donation or a restart changed a bit")


def lm_train_example(dev) -> None:
    """Phase 15 (d): examples/train_lm_torch.py on the card (300 steps of
    examples/train_lm.py's 5.0M-parameter minitron, a failure at step
    120): the loss falls."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import train_lm_torch

    losses = train_lm_torch.main(["--device", str(dev)])
    print(f"lm train (d): examples/train_lm_torch.py: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        fail("lm train (d): the example's loss did not fall")


def lm_train_cli(dev) -> None:
    """Phase 15 (e): ``python -m repro_torch.launch.train --smoke --steps 10
    --fail-at 4 --ckpt DIR`` on the card in a subprocess: exit 0, the
    reference's closing line, a checkpoint of step 10."""
    import tempfile

    from repro_torch.train import checkpoint

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                               "--steps", "10", "--fail-at", "4", "--ckpt", d],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        last = checkpoint.latest_step(d)
    done = [line for line in proc.stdout.splitlines() if line.startswith("[train] done")]
    print(f"lm train (e): the train CLI exit {proc.returncode}: {done}, last checkpoint {last}")
    if proc.returncode != 0 or len(done) != 1 or last != 10:
        fail(f"lm train (e): {proc.stdout} {proc.stderr}")


def run_lm_training(dev) -> None:
    """Phase 15: LM training, which launches no kernel of the port (the JAX
    package's loss and step reach no pallas_call): K1's, K2's and K3's
    launch counts are 0 at its start and still 0 at its end."""
    import torch

    torch.empty(0, device=dev)
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    phase("15a (minitron-8b train step at 4 of 32 layers)", lm_train_full, dev)
    torch.cuda.empty_cache()
    phase("15b (minitron-8b, card vs CPU at 1 layer)", lm_train_card_vs_cpu, dev)
    torch.cuda.empty_cache()
    phase("15c (donation and restarts on the card)", lm_train_donation, dev)
    phase("15d (examples/train_lm_torch.py)", lm_train_example, dev)
    phase("15e (the train CLI)", lm_train_cli, dev)
    launched = {c.__name__: c.launches for c in counters}
    print(f"LM training: kernel launches {launched}")
    if any(launched.values()):
        fail(f"LM training launched a kernel: {launched}")


# ---------------------------------------------------------------------------
# phase 16: the mesh and sharding layer (launch.mesh, dist.sharding, the
# cells of launch.steps, checkpoint.restore(shardings=), Trainer(mesh=),
# launch.dryrun)
# ---------------------------------------------------------------------------
def host_whole(tree) -> list:
    """Every leaf of a tree of DTensors (or tensors), whole, copied to the
    host (a donated step writes the leaves themselves)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train.tree import tree_leaves

    return [(x.full_tensor() if isinstance(x, DTensor) else x).to("cpu", copy=True)
            for x in tree_leaves(tree)]


def bits_or_error(got: list, want: list) -> tuple[bool, float]:
    """(every pair bit for bit, the largest difference of any pair)."""
    same = all(x.dtype == y.dtype and same_bits(x, y) for x, y in zip(got, want))
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
    return same, err


def event_ms(fn):
    """(``fn()``, its CUDA-event milliseconds)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def handing_grads(on_grads):
    """A context in which the steps launch.steps builds call
    ``on_grads(leaves)`` with the whole gradients (a DTensor gathered) of
    their first optimizer update, before it runs: it wraps
    ``train.optimizer.make``, which those steps call when they are built."""
    import contextlib

    from torch.distributed.tensor import DTensor

    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.tree import tree_leaves

    @contextlib.contextmanager
    def ctx():
        make, seen = opt_mod.make, []

        def handing_make(cfg):
            init, update = make(cfg)

            def update_handing(grads, state, params, donate=False):
                if not seen:
                    seen.append(True)
                    on_grads([g.full_tensor() if isinstance(g, DTensor) else g
                              for g in tree_leaves(grads)])
                return update(grads, state, params, donate=donate)
            return init, update_handing

        opt_mod.make = handing_make
        try:
            yield
        finally:
            opt_mod.make = make
    return ctx()


def mesh_train_cell(dev, mesh) -> None:
    """Phase 16 (a): the minitron-8b:train_4k cell (launch.steps'
    _lm_train_cell, which build_cell calls) at phase 15 (a)'s cuts (its
    published width, LM_TRAIN_LAYERS of 32 layers, a global batch of
    LM_TRAIN_BATCH) on the one-card mesh: the parameters and AdamW state
    placed by the cell's shardings, batches by its batch placements, one
    step then LM_TRAIN_TIMED timed by CUDA events (ms a step, peak memory);
    then launch.steps.lm_train_step from the same generator seed on the same
    first batch. On a 1 x 1 mesh every shard is the whole leaf, so the
    first step's loss, the gradients it hands AdamW and the parameters
    after it must have its bits; else the largest differences, with the
    loss and every gradient held to phase 15 (b)'s bounds (LM_TRAIN_LOSS_ATOL,
    each leaf within LM_TRAIN_GRAD_REL of its largest entry). Two 4-layer
    states do not fit the card together: the cell's first-step gradients
    and parameters wait on the host, and lm_train_step's gradients are
    compared with them leaf by leaf as its update receives them."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.nn import transformer as tfm

    cfg = lm_train_cfg(LM_TRAIN_LAYERS)
    shape = dataclasses.replace(LM_SHAPES["train_4k"], global_batch=LM_TRAIN_BATCH)
    cell_grads, grad_check = [], {}

    def keep(leaves):
        cell_grads.extend(g.to("cpu", copy=True) for g in leaves)

    def compare(leaves):
        same, rel = True, []
        for g, w in zip(leaves, cell_grads, strict=True):
            w = w.to(g.device)
            same = same and g.dtype == w.dtype and same_bits(g, w)
            scale = float(w.abs().max())
            err = float((g.float() - w.float()).abs().max())
            rel.append(err / scale if scale else (0.0 if err == 0 else float("inf")))
        grad_check.update(same=same, rel=rel)

    with handing_grads(keep):
        cell = steps._lm_train_cell(cfg, shape, mesh)
    rng = np.random.default_rng(16)
    batches = [lm_batch(rng, cfg, shape.global_batch, shape.seq_len)
               for _ in range(1 + LM_TRAIN_TIMED)]
    with handing_grads(compare):
        opt_init, plain_step = steps.lm_train_step(cfg, shape, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    p = shd.place(params, cell.in_shardings[0])
    s = shd.place(opt_init(params), cell.in_shardings[1])
    del params
    losses, ms, first = [], [], None
    for i, b in enumerate(batches):
        (p, s, m), t = event_ms(lambda: cell.step_fn(p, s, shd.place(b, cell.in_shardings[2])))
        losses.append(float(m["loss"].full_tensor()))
        if i == 0:
            first = host_whole(p)
        else:
            ms.append(t)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"mesh (a): {cfg.name} train_4k cell at {cfg.n_layers} of 32 layers, global batch "
          f"{shape.global_batch}, on a {tuple(mesh.shape)} mesh (placements: embed "
          f"{p['embed'].placements}, tokens {cell.in_shardings[2]['tokens'].placements}): step "
          f"ms (CUDA events) {[round(x, 3) for x in ms]}, median {statistics.median(ms):.3f} "
          f"(phase 15 (a) prints lm_train_step's); peak {peak / 2**30:.3f} GiB; "
          f"losses {[round(x, 6) for x in losses]}")
    del p, s, m
    torch.cuda.empty_cache()
    params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    params, state, m = plain_step(params, opt_init(params), batches[0])
    plain_loss, plain = float(m["loss"]), host_whole(params)
    del params, state
    torch.cuda.empty_cache()
    same, err = bits_or_error(first, plain)
    rel = max(grad_check["rel"])
    print(f"mesh (a): the cell's first step against lm_train_step's: loss {losses[0]:.9g} vs "
          f"{plain_loss:.9g}; gradients ({len(cell_grads)} leaves) "
          f"{'bit for bit' if grad_check['same'] else f'differ by {rel:.4e} of a leaf largest'}; "
          f"parameters {'bit for bit' if same else f'differ by {err:.4e}'}")
    if not np.isfinite(losses).all():
        fail(f"mesh (a): losses {losses}")
    if not (same and grad_check["same"] and losses[0] == plain_loss) and not (
            abs(losses[0] - plain_loss) <= LM_TRAIN_LOSS_ATOL and rel <= LM_TRAIN_GRAD_REL):
        fail(f"mesh (a): the cell is off lm_train_step: loss {losses[0]} vs {plain_loss}, "
             f"gradients by {rel} of a leaf's largest entry")


def mesh_serving_cells(dev, mesh) -> None:
    """Phase 16 (b), (c): the minitron-8b serving cells at its published
    width and depth with bfloat16 parameters (the cells' dtype), on the
    one-card mesh. (b) decode_32k cut to batch MESH_DECODE_BATCH: caches of
    32,768 positions drawn from a seeded generator, length
    MESH_DECODE_LENGTH; one step of the cell against tfm.decode_step on the
    same weights, token and cache (a copy): logits and the written caches
    bit for bit, else within phase 14 (b)'s bound; then 3 more steps of
    each, ms a step by CUDA events. (c) prefill_32k cut to batch 1: the
    cell against tfm.prefill, its last logits and cache the same way, and
    seconds of each."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.base import LM_SHAPES, get_arch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.nn import transformer as tfm
    from repro_torch.train.tree import tree_map

    cfg = get_arch(LM_ARCH)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev))
    torch.cuda.empty_cache()
    shape = dataclasses.replace(LM_SHAPES["decode_32k"], global_batch=MESH_DECODE_BATCH)
    cell = steps._lm_decode_cell(cfg, shape, mesh)
    p = shd.place(params, cell.in_shardings[0])
    gen = torch.Generator(device=dev).manual_seed(16)
    kv = (cfg.n_layers, shape.global_batch, shape.seq_len, cfg.n_kv, cfg.head_dim)
    k = torch.randn(kv, generator=gen, dtype=torch.bfloat16, device=dev)
    v = torch.randn(kv, generator=gen, dtype=torch.bfloat16, device=dev)
    plain = tfm.KVCache(k=k.clone(), v=v.clone(), length=MESH_DECODE_LENGTH)
    cache = shd.place(tfm.KVCache(k=k, v=v, length=torch.tensor(MESH_DECODE_LENGTH,
                                                                dtype=torch.int32)),
                      cell.in_shardings[1])
    del k, v
    rng = np.random.default_rng(16)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab, shape.global_batch).astype(np.int32))
              .to(dev) for _ in range(4)]
    torch.cuda.reset_peak_memory_stats(dev)
    cell_ms, plain_ms = [], []
    for i, tok in enumerate(tokens):
        (lc, cache), tc = event_ms(lambda: cell.step_fn(p, cache, shd.place(tok, cell.in_shardings[2])))
        (lp, plain), tp = event_ms(lambda: tfm.decode_step(params, cfg, plain, tok))
        if i == 0:
            same = same_bits(lc.full_tensor(), lp) and all(
                torch.equal(a.full_tensor(), b) for a, b in ((cache.k, plain.k), (cache.v, plain.v)))
            if not same:
                lm_close("mesh (b): the decode cell's logits vs tfm.decode_step's",
                         lc.full_tensor(), lp, LM_TF_TOL)
                lm_close("mesh (b): the cache position it wrote",
                         cache.k.full_tensor()[:, :, MESH_DECODE_LENGTH], plain.k[:, :, MESH_DECODE_LENGTH],
                         LM_TF_TOL)
            first = (same, float(lc.full_tensor().abs().max()))
        else:
            cell_ms.append(tc)
            plain_ms.append(tp)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"mesh (b): {cfg.name} decode_32k cell at batch {shape.global_batch} (of "
          f"{LM_SHAPES['decode_32k'].global_batch}), bfloat16 weights, caches of {shape.seq_len} "
          f"positions from length {MESH_DECODE_LENGTH} ({2 * plain.k.numel() * 2 / 1e9:.1f} GB a "
          f"cache): the first step's logits (up to {first[1]:.3f}) and caches against "
          f"tfm.decode_step {'bit for bit' if first[0] else 'within phase 14 (b) bounds'}; "
          f"ms a step (CUDA events) cell {[round(x, 3) for x in cell_ms]} median "
          f"{statistics.median(cell_ms):.3f}, tfm.decode_step {[round(x, 3) for x in plain_ms]} "
          f"median {statistics.median(plain_ms):.3f} (phase 14 (a) prints the step on float32 "
          f"weights cast each call, at batch 8); peak "
          f"{peak / 2**30:.3f} GiB; lengths {int(cache.length)} and {plain.length}")
    if int(cache.length) != plain.length:
        fail(f"mesh (b): cache lengths {cache.length} and {plain.length}")
    del cache, plain, lc, lp
    torch.cuda.empty_cache()

    shape = dataclasses.replace(LM_SHAPES["prefill_32k"], global_batch=1)
    cell = steps._lm_prefill_cell(cfg, shape, mesh)
    p = shd.place(params, cell.in_shardings[0])
    tok = torch.from_numpy(lm_prompts(cfg.vocab, 1, shape.seq_len, seed=3)).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    (lc, cc), tc = event_ms(lambda: cell.step_fn(p, shd.place(tok, cell.in_shardings[1])))
    (lp, cp), tp = event_ms(lambda: tfm.prefill(params, cfg, tok))
    peak = torch.cuda.max_memory_allocated(dev)
    same = same_bits(lc.full_tensor(), lp) and all(
        torch.equal(a.full_tensor(), b) for a, b in ((cc.k, cp.k), (cc.v, cp.v)))
    print(f"mesh (c): {cfg.name} prefill_32k cell at batch 1 (of "
          f"{LM_SHAPES['prefill_32k'].global_batch}): {tc / 1e3:.3f} s (CUDA events, first call), "
          f"tfm.prefill {tp / 1e3:.3f} s (phase 14 (d) prints it on float32 weights); last "
          f"logits and cache {'bit for bit' if same else 'differ'}; peak "
          f"{peak / 2**30:.3f} GiB")
    if not same:
        lm_close("mesh (c): the prefill cell's last logits vs tfm.prefill's", lc.full_tensor(), lp,
                 LM_TF_TOL)
        lm_close("mesh (c): its cache", cc.k.full_tensor()[:, :, -1], cp.k[:, :, -1], LM_TF_TOL)
    if not torch.isfinite(lp).all():
        fail("mesh (c): prefill logits not finite")


def mesh_restore_and_trainer(dev, mesh) -> None:
    """Phase 16 (d): at examples/train_lm.py's minitron width (2 layers),
    checkpoint.restore(..., shardings=) onto the card's mesh by the train
    cell's parameter shardings gives DTensors on the card with the saved
    bits; then, under deterministic algorithms, Trainer(mesh=,
    in_shardings=, out_shardings=) with 2 microbatches takes 3 steps with
    the unsharded Trainer's history and state bit for bit."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import LMShape, get_arch, reduced
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.nn import transformer as tfm
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import tree_leaves

    cfg = dataclasses.replace(reduced(get_arch(LM_ARCH)), **LM_TRAIN_SMALL)
    shape = LMShape("t", "train", 256, 4)
    cell = steps._lm_train_cell(cfg, shape, mesh)
    params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        checkpoint.save(d, 1, params)
        got = checkpoint.restore(d, 1, params, shardings=cell.in_shardings[0])
    leaves = tree_leaves(got)
    placed = all(isinstance(x, DTensor) and x.device_mesh == mesh
                 and x.to_local().device.type == dev.type for x in leaves)
    same, _ = bits_or_error(host_whole(got), host_whole(params))
    print(f"mesh (d): checkpoint.restore(shardings=) of {cfg.param_count():,} parameters: "
          f"DTensors on {dev.type} {placed}, the saved bits {same}")
    if not (placed and same):
        fail("mesh (d): the sharded restore")
    batch_fn = make_batch_fn("lm", cfg, shape, seed=5)

    def fit(on_mesh: bool):
        kw = {}
        if on_mesh:
            kw = dict(mesh=mesh, in_shardings=cell.in_shardings,
                      out_shardings=(cell.out_shardings[0], cell.out_shardings[1], shd.ns(mesh)))
        tr = Trainer(lambda q, b: tfm.loss_fn(q, cfg, b),
                     lambda: tfm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                                      device=dev),
                     OptConfig(lr=1e-3), TrainerConfig(num_steps=3, microbatches=2, log_every=1),
                     device=dev, **kw)
        with contextlib.redirect_stdout(io.StringIO()):
            state = tr.fit(batch_fn)
        return tr.history, host_whole(state)

    ((h_mesh, s_mesh), (h_plain, s_plain)), refused = deterministic(
        lambda: (fit(True), fit(False)))
    same, err = bits_or_error(s_mesh, s_plain)
    print(f"mesh (d): Trainer on the mesh vs unsharded, 3 steps (deterministic "
          f"{'no: ' + refused if refused else 'yes'}): history "
          f"{'equal' if h_mesh == h_plain else 'DIFFERENT'}, state "
          f"{'bit for bit' if same else f'differs by {err:.4e}'}; losses "
          f"{[round(h['loss'], 6) for h in h_mesh]}")
    if h_mesh != h_plain or not same:
        fail("mesh (d): Trainer(mesh=) changed a bit")


def mesh_dryrun() -> None:
    """Phase 16 (e): ``python -m repro_torch.launch.dryrun --mesh both
    --cells MESH_DRYRUN_CELLS`` in a subprocess (the fake backend at 256
    and 512 ranks, meta tensors: nothing on the card): exit 0 and every
    cell "ok"; each record's summary printed."""
    import tempfile

    import torch

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        out = os.path.join(d, "dryrun.json")
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "both",
                               "--cells", MESH_DRYRUN_CELLS, "--out", out], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=MESH_DRYRUN_TIMEOUT)
        records = json.load(open(out)) if os.path.exists(out) else []
    for r in records:
        if r["status"] == "ok":
            print(f"mesh (e): {r['arch']}:{r['shape']} on {r['mesh']} ({r['devices']} devices): "
                  f"ok in {r['compile_s']} s; bytes a device {r['bytes_per_device']:,} "
                  f"({r['bytes_kind']}); GFLOP a device {r['hlo_gflops_per_dev']} (traced "
                  f"{r['traced_gflops_per_dev']:.3f}); collective GB {r['coll_breakdown']}; "
                  f"dominant {r['dominant']} (compute {r['compute_s']:.4g} s, memory "
                  f"{r['memory_s']:.4g} s, collective {r['collective_s']:.4g} s); {r['traced']}")
        else:
            where = [ln.strip() for ln in r.get("traceback", "").splitlines() if "repro_torch" in ln]
            print(f"mesh (e): {r['arch']}:{r['shape']} on {r['mesh']}: {r['status']}: "
                  f"{r.get('error')} (at {where[-3:]})")
    print(f"mesh (e): the dry-run (torch {torch.__version__}): exit {proc.returncode}, "
          f"{sum(r['status'] == 'ok' for r in records)}/{len(records)} ok")
    want = 2 * len(MESH_DRYRUN_CELLS.split(","))
    if proc.returncode != 0 or len(records) != want or any(r["status"] != "ok" for r in records):
        fail(f"mesh (e): the dry-run: {proc.stdout[-3000:]} {proc.stderr[-3000:]}")


def run_mesh(dev) -> None:
    """Phase 16: the mesh and sharding layer on one card: an NCCL
    world-size-1 process group (a file:// store under build/, as phase 12),
    make_debug_mesh(1, 1) on the card, the cells of (a)-(d), then the
    dry-run (e). It launches no kernel of the port (the cells call the
    plain routes, as the JAX package's cells call impl="jnp"): K1's, K2's
    and K3's launch counts are 0 at its start and still 0 at its end."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type=dev.type)
        phase("16a (the minitron-8b train_4k cell at 4 of 32 layers)", mesh_train_cell, dev, mesh)
        torch.cuda.empty_cache()
        phase("16b-c (the minitron-8b decode_32k and prefill_32k cells)", mesh_serving_cells,
              dev, mesh)
        torch.cuda.empty_cache()
        phase("16d (sharded restore and Trainer on the mesh)", mesh_restore_and_trainer, dev,
              mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    phase("16e (the dry-run)", mesh_dryrun)
    launched = {c.__name__: c.launches for c in counters}
    print(f"mesh and sharding: kernel launches {launched}")
    if any(launched.values()):
        fail(f"the mesh phase launched a kernel: {launched}")


# ---------------------------------------------------------------------------
# phase 17: PNA inference over a whole graph, the kron21.pna cell's forward

PNA_CELL = "kron21.pna"
PNA_SEED = 2**31 + 1717   # the graph's labels, then the features and weights


def run_pna_whole_graph(dev) -> list:
    """Phase 17: PNA at its published widths over the kron21 graph, the
    forward of the benchmark cell kron21.pna (``gbench/apps/pna.py``: the
    cell's graph, features, weights and inputs from one seed), through
    nn.gnn.apply's blocked layer. K1's launch count is set to 0 just before
    one forward and must be n_layers x blocks just after it; every launch
    of the first two layers (d = 100 and d = 75, K1's two row kernels) is
    held bit for bit against hot_gather_two_tier_ref on the path's own
    (h, src block, hot_size); the logits are finite. The same forward must
    launch ``segment_stats`` n_layers x blocks times, and a second forward
    holds each of its launches, on the path's own messages and offsets,
    against the float64 check ``kernels/segment_reduce/ref.check`` (sums
    within the kernel's error bound, extremes exact) and relaunches it bit
    for bit. Returns K1's kernel entries at the two widths, timed on the
    launches of one layer each, and the segment-reduce entry, timed on the
    last layer's blocks (``pna_reduce_numbers``)."""
    import torch

    from gbench import graphs, spec
    from gbench.apps import pna as pna_app
    from repro_torch.kernels.hot_gather import ops, ref
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_stats
    from repro_torch.nn import gnn

    bench = spec.benchmark()
    cell = spec.cell(bench, PNA_CELL)
    t0 = time.perf_counter()
    g = graphs.make(spec.config(bench, cell["config"]), PNA_SEED, dev, weighted=False)
    app = pna_app.App(g, spec.traffic(cell["traffic"]), dev)
    torch.cuda.synchronize()
    blocks = gnn.pna_blocks(g.indptr, gnn.BLOCK_EDGES)
    layers = app.cfg.n_layers
    print(f"PNA graph {cell['config']} (seed {PNA_SEED}): N {g.num_nodes}, E {g.num_edges}, "
          f"{len(blocks)} blocks a layer ({time.perf_counter() - t0:.1f} s); {app.describe()}")

    seen = []   # (h, src block, hot_size) of every K1 launch of the forward, in order
    real = ops.hot_gather

    def recording(prop, idx, hot_size=None):
        seen.append((prop, idx, hot_size))
        return real(prop, idx, hot_size)

    app.warm_up()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    hot_gather_hot_part.launches = segment_stats.launches = 0
    ops.hot_gather = recording
    try:
        t0 = time.perf_counter()
        logits = app.trial(0, {})
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
    finally:
        ops.hot_gather = real
    launches, reduces = hot_gather_hot_part.launches, segment_stats.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"PNA forward: {forward_s:.4f} s, logits {tuple(logits.shape)}, K1 launches "
          f"{launches}, segment_stats launches {reduces} (want {layers} x {len(blocks)} each), "
          f"peak {peak:.4f} GiB")
    if launches != layers * len(blocks) or len(seen) != launches:
        fail(f"PNA: K1 launched {launches} times ({len(seen)} recorded), not "
             f"{layers} x {len(blocks)}")
    if reduces != layers * len(blocks):
        fail(f"PNA: segment_stats launched {reduces} times, not {layers} x {len(blocks)}")
    if logits.shape != (g.num_nodes, app.cfg.d_out) or not torch.isfinite(logits).all():
        fail("PNA: logits not finite or of the wrong shape")
    del logits

    entries = []
    for layer, path, count in ((0, "kron21.pna d=100", 1),
                               (1, "kron21.pna d=75", layers - 1)):
        mix = [(h, hot, idx) for h, idx, hot in seen[layer * len(blocks):
                                                      (layer + 1) * len(blocks)]]
        err = 0.0
        for h, hot, idx in mix:
            got = ops.hot_gather(h, idx, hot)
            want = ref.hot_gather_two_tier_ref(h, idx, hot)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                fail(f"K1 on {path} (hot {hot} of N={h.shape[0]}, E={idx.shape[0]}): differs "
                     f"from its plain version")
            err = max(err, float((got - want).nan_to_num(nan=0.0).abs().max()))
            del got, want
        print(f"K1 on {path}: {len(mix)} launches of layer {layer} bit-identical to "
              f"hot_gather_two_tier_ref (d={mix[0][0].shape[1]}, hot_size {mix[0][1]})")
        res = k1_numbers(path, mix, [count] * len(mix), err, two_tier=True)
        entries.append(dict(name="hot_gather", route="cuda",
                            source="src/repro_torch/csrc/hot_gather.cu",
                            replaces="src/repro/kernels/hot_gather/hot_gather.py:26",
                            path=path, **res))
        torch.cuda.empty_cache()
    del seen, mix
    torch.cuda.empty_cache()
    entries.append(pna_reduce_numbers(app, g, blocks))
    return entries


def pna_reduce_numbers(app, g, blocks) -> dict:
    """Phase 17's second forward, each ``segment_stats`` launch held against
    ``ref.check`` and relaunched bit for bit; then the kernel's times on
    the last layer's blocks: a layer's launches (``ms``, ``device_ms``,
    ``host_us``) beside their byte bound (4·E·d + 4(R + 1) + 16·R·d a
    block), the plain version (``plain_ms``) and the four library calls
    the layer made before, two ``index_add_`` over the block's int32 ids
    and two ``torch.segment_reduce`` (``library_ms``, ``library_device_ms``)."""
    import torch

    from repro_torch.kernels.segment_reduce import ref
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_stats
    from repro_torch.nn import gnn

    layers, path = app.cfg.n_layers, "kron21.pna, a layer's blocks"
    seen, kept, worst = [], [], 0.0   # errors over the bound; the last layer's (m, offsets)

    def checking(m, offsets):
        out = segment_stats(m, offsets)
        again = segment_stats(m, offsets)
        ok, err = ref.check(out, m, offsets)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
            fail(f"segment_stats on {path}: two launches differ")
        if not ok:
            fail(f"segment_stats on {path} (E {m.shape[0]}, R {offsets.shape[0] - 1}): outside "
                 f"ref.check's bound (largest error over it {err:.4e})")
        nonlocal worst
        worst = max(worst, err)
        seen.append(err)
        if len(seen) > (layers - 1) * len(blocks):
            kept.append((m, offsets))
        return out

    gnn.segment_stats = checking
    try:
        logits = app.trial(0, {})
        torch.cuda.synchronize()
    finally:
        gnn.segment_stats = segment_stats
    if len(seen) != layers * len(blocks) or not torch.isfinite(logits).all():
        fail(f"PNA: the checked forward made {len(seen)} segment_stats calls for {layers} x "
             f"{len(blocks)}")
    del logits
    print(f"segment_stats on {path}: {len(seen)} launches of a forward within ref.check's bound "
          f"of float64 (largest error over its bound {worst:.4e}), extremes exact, each "
          f"relaunched bit for bit")

    ids = [g.dst[e0:e1] - v0 for v0, _, e0, e1 in blocks]

    def library():
        for (m, offsets), seg in zip(kept, ids):
            rows = (offsets.shape[0] - 1, m.shape[1])
            m.new_zeros(rows).index_add_(0, seg, m)
            m.new_zeros(rows).index_add_(0, seg, m * m)
            gnn._seg_extreme_sorted(m, offsets, "amax")
            gnn._seg_extreme_sorted(m, offsets, "amin")

    res = timed("", lambda: [segment_stats(m, o) for m, o in kept], reps=10, calls=20)
    res["plain_ms"] = time_ms(lambda: [ref.segment_stats_ref(m, o) for m, o in kept], reps=3,
                              warmup=1)
    res["library_ms"] = time_ms(library, reps=3, warmup=1)
    res["library_device_ms"] = device_ms(library, reps=3)
    nbytes = sum(4 * m.numel() + 4 * o.numel() + 16 * (o.numel() - 1) * m.shape[1]
                 for m, o in kept)
    res["bound_ms"], res["bound_by"] = bound(nbytes)
    e, d = sum(m.shape[0] for m, _ in kept), kept[0][0].shape[1]
    res.update(max_err_over_bound=worst, launches=layers * len(blocks),
               shape=f"E={e} float32 messages of d={d} over N={g.num_nodes} rows in "
                     f"{len(kept)} blocks a layer, {layers} layers a forward")
    print(f"segment_stats on {path} ({res['shape']}), per layer: {res['ms']:.4f} ms (device "
          f"{fmt_ms(res['device_ms'])}, host {res['host_us']:.2f} us/call), plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms; the four library calls "
          f"{res['library_ms']:.4f} ms (device {fmt_ms(res['library_device_ms'])})")
    del kept, ids
    torch.cuda.empty_cache()
    return dict(name="segment_reduce", route="cuda", source="src/repro_torch/csrc/segment_reduce.cu",
                replaces="none: the JAX package aggregates PNA with XLA's jax.ops.segment_sum, "
                         "segment_max and segment_min",
                path=path, **res)


# ---------------------------------------------------------------------------
# phase 18: the segment-sum kernel at the PRD cells' shapes

SEGSUM_CELLS = ("kron25.prd", "urand25.prd")
SEGSUM_SEED = 2**31 + 2929   # the graphs' labels
SEGSUM_PRD_ITERS = 3         # PageRank-Delta's iterations whose launches phase 18 counts


def segsum_errors(got, exact, lengths, roundings_per_edge: float, roundings: float):
    """(every row within its bound, the largest error over its row's sum) of
    a sum of positive messages against its float64 sum: the bound is
    ``roundings + roundings_per_edge * length`` float32 roundings of the
    row's sum, which for positive messages is its sum of magnitudes."""
    import torch

    err = (got.double() - exact).abs()
    ok = bool((err <= (roundings + roundings_per_edge * lengths) * 2.0**-24 * exact).all())
    rel = err / exact.clamp(min=1e-300)
    return ok and bool(torch.isfinite(got).all()), float(rel.max())


def run_segment_sum(dev) -> list:
    """Phase 18: the segment-sum kernel on the graphs of the benchmark cells
    kron25.prd and urand25.prd (``gbench/graphs.py``, a fixed seed). First
    ``apps.pagerank_delta`` runs there, as the cells run it, for
    ``SEGSUM_PRD_ITERS`` iterations with the launch count set to 0: it must
    launch the kernel once an iteration, and that count is the entry's
    ``launches``. Then PageRank-Delta's first messages (the initial ranks
    over the out-degrees, gathered through K1): two launches must repeat
    bit for bit and each row must lie within the kernel's error bound of
    its float64 sum, (64 + length / 1024) roundings of the row's sum (the
    kernel's own is 30 + the tiles the row spans); the plain version
    (``index_add_`` over the rows' ids) within its serial bound of (1 +
    length) roundings. Times per launch: the kernel (``ms``, ``device_ms``,
    ``host_us``), the plain version (``plain_ms``) and ``index_add_`` over
    the CSR's ``dst``, what the pull ran before (``library_ms``,
    ``library_device_ms``); the bound reads the messages and offsets once
    and writes the sums once (4E + 4(N + 1) + 4N bytes)."""
    import torch

    from gbench import graphs, spec
    from repro_torch import apps
    from repro_torch.apps import engine
    from repro_torch.graph.csr import DeviceCSR
    from repro_torch.kernels.segment_sum import ref
    from repro_torch.kernels.segment_sum.segment_sum import segment_sum

    bench = spec.benchmark()
    entries = []
    for name in SEGSUM_CELLS:
        cell = spec.cell(bench, name)
        t0 = time.perf_counter()
        g = graphs.make(spec.config(bench, cell["config"]), SEGSUM_SEED, dev, weighted=False)
        n, e = g.num_nodes, g.num_edges
        csr = DeviceCSR(indptr=g.indptr, indices=g.indices, dst=g.dst, weights=None,
                        num_nodes=n)
        out_deg = engine.sum_reduce(torch.ones(e, device=dev), g.indices, n)
        msgs = engine.gather_src(csr, torch.full((n,), 0.15 / n, device=dev)
                                 / out_deg.clamp(min=1.0))
        del out_deg
        torch.cuda.synchronize()
        print(f"segment sum on {name}'s graph (seed {SEGSUM_SEED}): N {n}, E {e} "
              f"({time.perf_counter() - t0:.1f} s)")
        stats = {}
        segment_sum.launches = 0
        apps.pagerank_delta(csr, max_iters=SEGSUM_PRD_ITERS, stats=stats)
        torch.cuda.synchronize()
        launches = segment_sum.launches
        print(f"segment sum on {name}: PageRank-Delta, {stats['iters']} iterations, "
              f"segment-sum launches {launches}")
        if launches != stats["iters"] or launches < 1:
            fail(f"segment sum on {name}: PageRank-Delta launched the kernel {launches} times "
                 f"in {stats['iters']} iterations")

        before = segment_sum.launches
        got = segment_sum(msgs, g.indptr, n)
        again = segment_sum(msgs, g.indptr, n)
        torch.cuda.synchronize()
        if segment_sum.launches - before != 2:
            fail(f"segment sum on {name}: {segment_sum.launches - before} launches for 2 calls")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"segment sum on {name}: two launches differ")
        del again
        exact = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, g.dst,
                                                                          msgs.double())
        lengths = (g.indptr[1:] - g.indptr[:-1]).double()
        ok, rel = segsum_errors(got, exact, lengths, 1 / 1024, 64)
        plain = ref.segment_sum_ref(msgs, g.indptr, n)
        plain_ok, plain_rel = segsum_errors(plain, exact, lengths, 1, 1)
        del plain, exact, lengths
        print(f"segment sum on {name}: largest error over a row's sum {rel:.3e} (plain "
              f"version {plain_rel:.3e}); every row within its bound: kernel {ok}, plain "
              f"{plain_ok}; two launches bit for bit")
        if not ok or not plain_ok:
            fail(f"segment sum on {name}: a row outside its bound (kernel {ok}, plain "
                 f"{plain_ok})")
        del got

        res = timed("", lambda: segment_sum(msgs, g.indptr, n))
        res["plain_ms"] = time_ms(lambda: ref.segment_sum_ref(msgs, g.indptr, n))

        def library():
            return msgs.new_zeros(n).index_add_(0, g.dst, msgs)

        res["library_ms"], res["library_device_ms"] = time_ms(library), device_ms(library)
        res["bound_ms"], res["bound_by"] = bound(4 * e + 4 * (n + 1) + 4 * n)
        res.update(max_rel_err=rel, plain_max_rel_err=plain_rel, launches=launches,
                   shape=f"E={e} float32 messages over N={n} rows, 1 an iteration")
        print(f"segment sum on {name} ({res['shape']}), per launch: {res['ms']:.4f} ms "
              f"(device {fmt_ms(res['device_ms'])}, host {res['host_us']:.2f} us/call), "
              f"plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms; index_add_ "
              f"over dst {res['library_ms']:.4f} ms (device "
              f"{fmt_ms(res['library_device_ms'])})")
        entries.append(dict(name="segment_sum", route="cuda",
                            source="src/repro_torch/csrc/segment_sum.cu",
                            replaces="none: the JAX package's pull sums with XLA's "
                                     "jax.ops.segment_sum",
                            path=f"{name} shape", **res))
        del g, csr, msgs
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phase 19: GAT inference over a whole graph, the kron21.gat cell's forward

GAT_CELL = "kron21.gat"
GAT_SEED = 2**31 + 1919      # the graph's labels, then the features and weights
GAT_CHECK_ITEMS = 1 << 20    # items a block of the float64 plain version: 4.3 GB of 2 KB rows


def gat_attend_bytes(n: int, e: int, heads: int, width: int, out_width: int) -> int:
    """The least bytes of one gat_attend call: the offsets, the ids, both
    scores and each row of z read once, each output row written once."""
    return 4 * (n + 1) + 4 * e + 8 * heads * n + 4 * width * n + 4 * out_width * n


def run_gat_whole_graph(dev) -> list:
    """Phase 19: GAT at the ogbn-products widths over the kron21 graph, the
    forward of the benchmark cell kron21.gat (``gbench/apps/gat.py``: the
    cell's graph, features, weights and inputs from one seed), through
    nn.gnn.apply's CSR route. ``gat_attend.launches`` is set to 0 just
    before one forward and must be n_layers just after it; the logits are
    finite. In a second forward every launch is held, on its own card
    tensors and before the layer's update writes over its output, against
    ``ref.gat_attend_ref`` in float64 within ``ref.error_bound`` (the card
    tests' bound), and launched again bit for bit. Returns the kernel's
    entries at its two row widths, timed on the inputs of the first layer
    (2 KB rows, as the second) and the last (752 B)."""
    import torch

    from gbench import graphs, spec
    from gbench.apps import gat as gat_app
    from repro_torch.kernels.gat_attend import ref
    from repro_torch.kernels.gat_attend.gat_attend import gat_attend
    from repro_torch.nn import gnn

    bench = spec.benchmark()
    cell = spec.cell(bench, GAT_CELL)
    t0 = time.perf_counter()
    g = graphs.make(spec.config(bench, cell["config"]), GAT_SEED, dev, weighted=False)
    app = gat_app.App(g, spec.traffic(cell["traffic"]), dev)
    torch.cuda.synchronize()
    n, e, layers = g.num_nodes, g.num_edges, app.cfg.n_layers
    print(f"GAT graph {cell['config']} (seed {GAT_SEED}): N {n}, E {e} "
          f"({time.perf_counter() - t0:.1f} s); {app.describe()}")

    app.warm_up()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gat_attend.launches = 0
    t0 = time.perf_counter()
    logits = app.trial(0, {})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = gat_attend.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"GAT forward: {forward_s:.4f} s, logits {tuple(logits.shape)}, gat_attend launches "
          f"{launches} (want {layers}), peak {peak:.4f} GiB")
    if launches != layers:
        fail(f"GAT: gat_attend launched {launches} times in a {layers}-layer forward")
    if logits.shape != (n, app.cfg.d_out) or not torch.isfinite(logits).all():
        fail("GAT: logits not finite or of the wrong shape")
    del logits

    entries, seen = [], []

    def checking(indptr, src, z, s_src, s_dst, hot_size, negative_slope, mean):
        def launch():
            return gat_attend(indptr, src, z, s_src, s_dst, hot_size, negative_slope, mean)

        out = launch()
        layer = len(seen)
        seen.append(hot_size)
        heads, width = s_src.shape[1], z.shape[1]
        path = f"kron21.gat, {4 * width} B rows"
        again = launch()
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
            fail(f"gat_attend on {path}: two launches on layer {layer}'s inputs differ")
        del again
        err = ref.gat_attend_ref(indptr, src, z.double(), s_src.double(), s_dst.double(),
                                 negative_slope, mean)
        err.sub_(out).abs_()
        limit = ref.error_bound(indptr, src, z, s_src, s_dst, negative_slope, mean)
        ok = bool((err <= limit).all()) and bool(torch.isfinite(out).all())
        worst = float(err.div_(limit).max())
        del err, limit
        print(f"gat_attend on {path}, layer {layer} (hot_size {hot_size}, "
              f"{'averaged' if mean else 'concatenated'} heads): within ref.error_bound of "
              f"the float64 plain version {ok} (largest error over its bound {worst:.4e}); "
              f"two launches bit for bit")
        if not ok:
            fail(f"gat_attend on {path}, layer {layer}: outside its error bound")
        if layer not in (0, layers - 1):
            return out
        count = layers - 1 if layer == 0 else 1
        res = timed("", launch, reps=10, calls=20)
        ref.BLOCK_ITEMS = block_items
        try:
            res["plain_ms"] = time_ms(lambda: ref.gat_attend_ref(
                indptr, src, z, s_src, s_dst, negative_slope, mean), reps=3, warmup=1)
        finally:
            ref.BLOCK_ITEMS = GAT_CHECK_ITEMS
        res["bound_ms"], res["bound_by"] = bound(gat_attend_bytes(n, e, heads, width,
                                                                  out.shape[1]))
        res.update(max_err_over_bound=worst, launches=count, hot_size=hot_size,
                   shape=f"H={heads} x C={width // heads} float32 rows of z over N={n}, "
                         f"E={e}, {count} a forward")
        print(f"gat_attend on {path} ({res['shape']}), per launch: {res['ms']:.4f} ms "
              f"(device {fmt_ms(res['device_ms'])}, host {res['host_us']:.2f} us/call), plain "
              f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms")
        entries.append(dict(name="gat_attend", route="cuda",
                            source="src/repro_torch/csrc/gat_attend.cu",
                            replaces="none: the JAX package has no GAT", path=path, **res))
        return out

    block_items = ref.BLOCK_ITEMS
    ref.BLOCK_ITEMS = GAT_CHECK_ITEMS
    gnn.gat_attend = checking
    try:
        logits = app.trial(0, {})
        torch.cuda.synchronize()
    finally:
        gnn.gat_attend = gat_attend
        ref.BLOCK_ITEMS = block_items
    if len(seen) != layers or not torch.isfinite(logits).all():
        fail(f"GAT: the checked forward made {len(seen)} gat_attend calls for {layers} layers")
    del logits, app, g
    torch.cuda.empty_cache()
    return entries


DEEPERGCN_CELL = "kron21.deepergcn"
DEEPERGCN_SEED = 2**31 + 2020  # the graph's labels, then the features and weights
SFU_PER_S = 132 * 16 * 1.98e9  # H100 SXM: 16 ex2 a clock an SM, at its 1.98 GHz boost


def softmax_aggr_bytes(n: int, e: int, width: int) -> int:
    """The least bytes of one softmax_aggr call: the offsets, the ids and
    each row of u read once, each output row written once."""
    return 4 * (n + 1) + 4 * e + 8 * width * n


def run_deepergcn_whole_graph(dev) -> list:
    """Phase 20: DeeperGCN at the ogbn-products widths over the kron21
    graph, the forward of the benchmark cell kron21.deepergcn
    (``gbench/apps/deepergcn.py``: the cell's graph, features and weights
    from one seed, the norms' statistics fitted by one float64 forward of
    the plain reference, whose logits are the cell's answer), through
    nn.gnn.apply's CSR route. ``softmax_aggr.launches`` is set to 0 just
    before one forward and must be n_layers just after it; the logits are
    within the cell's ``logit_err`` limit of the answer. In a second
    forward every launch is held, on its own card tensors, against
    ``ref.softmax_aggr_ref`` in float64 within ``ref.error_bound`` (the card
    tests' bound), and launched again bit for bit. Returns the kernel's
    entry, timed on the last layer's inputs (every layer's rows are 512 B)."""
    import torch

    from gbench import graphs, spec
    from gbench.apps import deepergcn as deepergcn_app
    from repro_torch.kernels.softmax_aggr import ref
    from repro_torch.kernels.softmax_aggr.softmax_aggr import softmax_aggr
    from repro_torch.nn import gnn

    bench = spec.benchmark()
    cell = spec.cell(bench, DEEPERGCN_CELL)
    t0 = time.perf_counter()
    g = graphs.make(spec.config(bench, cell["config"]), DEEPERGCN_SEED, dev, weighted=False)
    app = deepergcn_app.App(g, spec.traffic(cell["traffic"]), dev)
    torch.cuda.synchronize()
    n, e, layers = g.num_nodes, g.num_edges, app.cfg.n_layers
    print(f"DeeperGCN graph {cell['config']} (seed {DEEPERGCN_SEED}): N {n}, E {e}, the "
          f"norms fitted ({time.perf_counter() - t0:.1f} s); {app.describe()}")

    app.warm_up()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    softmax_aggr.launches = 0
    t0 = time.perf_counter()
    logits = app.trial(0, {})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = softmax_aggr.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    err = app.compare(logits.cpu(), app.references([0])[0])["logit_err"]
    limit = spec.limits(DEEPERGCN_CELL)["logit_err"]
    rms = float(app.answer.pow(2).mean().sqrt())
    print(f"DeeperGCN forward: {forward_s:.4f} s, logits {tuple(logits.shape)}, softmax_aggr "
          f"launches {launches} (want {layers}), peak {peak:.4f} GiB; logit_err {err:.4e} "
          f"(limit {limit}) against the float64 reference, whose logits' RMS is {rms:.4f}")
    if launches != layers:
        fail(f"DeeperGCN: softmax_aggr launched {launches} times in a {layers}-layer forward")
    if logits.shape != (n, app.cfg.d_out) or not err <= limit:
        fail(f"DeeperGCN: logits of shape {tuple(logits.shape)}, logit_err {err} over {limit}")
    del logits

    entries, seen = [], []

    def checking(indptr, src, u, hot_size, t, eps):
        def launch():
            return softmax_aggr(indptr, src, u, hot_size, t, eps)

        out = launch()
        layer = len(seen)
        seen.append(hot_size)
        path = f"kron21.deepergcn, {4 * u.shape[1]} B rows"
        again = launch()
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
            fail(f"softmax_aggr on {path}: two launches on layer {layer}'s inputs differ")
        del again
        err = ref.softmax_aggr_ref(indptr, src, u.double(), t, eps)
        err.sub_(out).abs_()
        limit = ref.error_bound(indptr, src, u, t, eps)
        ok = bool((err <= limit).all()) and bool(torch.isfinite(out).all())
        worst = float(err.div_(limit).max())
        del err, limit
        print(f"softmax_aggr on {path}, layer {layer} (hot_size {hot_size}): within "
              f"ref.error_bound of the float64 plain version {ok} (largest error over its bound "
              f"{worst:.4e}); two launches bit for bit")
        if not ok:
            fail(f"softmax_aggr on {path}, layer {layer}: outside its error bound")
        if layer != layers - 1:
            return out
        res = timed("", launch, reps=10, calls=20)
        res["plain_ms"] = time_ms(lambda: ref.softmax_aggr_ref(indptr, src, u, t, eps),
                                  reps=3, warmup=1)
        res["bound_ms"], res["bound_by"] = bound(softmax_aggr_bytes(n, e, u.shape[1]))
        res["exp_bound_ms"] = (n + e) * u.shape[1] / SFU_PER_S * 1e3
        res.update(max_err_over_bound=worst, launches=layers, hot_size=hot_size,
                   shape=f"{u.shape[1]} float32 channels of u over N={n}, E={e}, "
                         f"{layers} a forward")
        print(f"softmax_aggr on {path} ({res['shape']}), per launch: {res['ms']:.4f} ms "
              f"(device {fmt_ms(res['device_ms'])}, host {res['host_us']:.2f} us/call), plain "
              f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms of bytes, "
              f"{res['exp_bound_ms']:.4f} ms of exponentials")
        entries.append(dict(name="softmax_aggr", route="cuda",
                            source="src/repro_torch/csrc/softmax_aggr.cu",
                            replaces="none: the JAX package has no DeeperGCN", path=path, **res))
        return out

    gnn.softmax_aggr = checking
    try:
        logits = app.trial(0, {})
        torch.cuda.synchronize()
    finally:
        gnn.softmax_aggr = softmax_aggr
    if len(seen) != layers or not torch.isfinite(logits).all():
        fail(f"DeeperGCN: the checked forward made {len(seen)} softmax_aggr calls for {layers} "
             "layers")
    del logits, app, g
    torch.cuda.empty_cache()
    return entries


def phase(label: str, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


# phases that ``--only`` runs alone after the set-up (phase 1 is not needed:
# 14-16 launch no kernel of the port, and 17-20 build theirs at their first
# launch; 17-20 print their own kernels lines)
ONLY = {"14": lambda dev: phase("14 (LM serving)", run_lm_serving, dev),
        "15": lambda dev: phase("15 (LM training)", run_lm_training, dev),
        "16": lambda dev: phase("16 (the mesh and sharding layer)", run_mesh, dev),
        "17": lambda dev: print(json.dumps({"kernels": phase(
            "17 (PNA over a whole graph)", run_pna_whole_graph, dev)})),
        "18": lambda dev: print(json.dumps({"kernels": phase(
            "18 (the segment sum at the PRD cells' shapes)", run_segment_sum, dev)})),
        "19": lambda dev: print(json.dumps({"kernels": phase(
            "19 (GAT over a whole graph)", run_gat_whole_graph, dev)})),
        "20": lambda dev: print(json.dumps({"kernels": phase(
            "20 (DeeperGCN over a whole graph)", run_deepergcn_whole_graph, dev)}))}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one card and check it.")
    ap.add_argument("--only", default="", help=f"comma-separated phases of {sorted(ONLY)} "
                    "to run alone (no final result line; kernels lines from 17-20 only)")
    only = [x for x in ap.parse_args(argv).only.split(",") if x]
    if set(only) - set(ONLY):
        ap.error(f"--only takes phases of {sorted(ONLY)}")
    # phase 12's GRASP step frees and takes 20-32 GiB message tensors among
    # 1 GiB activations: with fixed segments the caching allocator split the
    # freed blocks and a later 20.47 GiB tensor found no room (OOM with 21 GiB
    # cached and 17 GiB free); expandable segments map the pages anew
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # without the repository's sources this import fails before any output
    from repro_torch.kernels import _build  # noqa: F401

    t_start = time.perf_counter()
    # cuBLAS's deterministic workspace, for phase 11's restart check under
    # torch.use_deterministic_algorithms (read before the first product)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matrix products are on: MIND's float32 scores need them off")
    if only:
        print(sys.version.split()[0], torch.__version__, torch.version.cuda)
        for name in only:
            ONLY[name](dev)
        print(f"total: {time.perf_counter() - t_start:.1f} s (phases {only} alone)")
        print(card)
        return 0
    phase("1 (build with nvcc, sm_90a)", build_all)

    t0 = time.perf_counter()
    qs_graph = dbg_graph("tw", 13)
    real_graph = dbg_graph("lj", REAL_SCALE)
    print(f"graphs: lj scale {REAL_SCALE} has {real_graph.num_nodes} vertices, "
          f"{real_graph.num_edges} edges ({time.perf_counter() - t0:.1f} s on the host)")

    k1_mix, k1_err = phase("2 (K1)", check_k1, dev, qs_graph, real_graph)
    k2 = phase("3 (K2)", check_k2, dev)
    qs_launches = phase("4 (quickstart)", run_quickstart, dev)
    real_launches = phase("5 (real-size PageRank)", run_real_pagerank, dev, real_graph)

    from repro_torch.configs.base import get_arch
    from repro_torch.nn import recsys

    t0 = time.perf_counter()
    params = recsys.init(torch.Generator().manual_seed(0), get_arch("mind"), device=dev)
    print(f"MIND parameters at full width: items {tuple(params['items'].shape)} f32 "
          f"({time.perf_counter() - t0:.1f} s)")
    k3 = phase("6 (K3)", check_k3, dev, params["items"])
    dense_mix, dense_launches, dense_err = phase("7 (MIND dense)", check_mind_dense, dev,
                                                 params)
    cache_mix, cache_counts, cache_err = phase("8 (MIND stream)", run_mind_stream, dev, params)
    phase("9a (graph suite)", run_graph_suite, dev)
    phase("9b (policies)", run_policies, qs_graph)
    prd_launches, sm = phase("9c (real-size suite)", run_real_suite, dev, real_graph)
    gnn_mix, gnn_counts, gnn_err = phase("10 (GNN serving)", run_gnn_serving, dev, real_graph)

    # the quickstart launches K1 once per PageRank iteration, then once in step 5
    # the serve cache runs K1's hot-part mode; the others go through ops.hot_gather
    k1_qs = k1_numbers("quickstart", k1_mix["quickstart"], [qs_launches - 1, 1],
                       k1_err["quickstart"], two_tier=True)
    k1_real = k1_numbers("real-size pagerank", k1_mix["real-size pagerank"], [real_launches],
                         k1_err["real-size pagerank"], two_tier=True)
    k1_cache = k1_numbers("mind serve cache", cache_mix, cache_counts, cache_err,
                          two_tier=False)
    k1_dense = k1_numbers("mind serve_scores hot", dense_mix, [dense_launches], dense_err,
                          two_tier=True)
    k1_gnn = k1_numbers("gnn serve cache", gnn_mix, gnn_counts, gnn_err, two_tier=False)
    # PageRank-Delta gathers (N,) f32 over the same graph as PageRank
    k1_prd = k1_numbers("real-size pagerank-delta", k1_mix["real-size pagerank"],
                        [prd_launches], k1_err["real-size pagerank"], two_tier=True)
    source = "src/repro_torch/csrc/hot_gather.cu"
    k1_tpu = "src/repro/kernels/hot_gather/hot_gather.py:26"
    kernels = [
        dict(name="hot_gather", route="cuda", source=source, replaces=k1_tpu,
             path="quickstart", **k1_qs),
        dict(name="hot_gather", route="cuda", source=source, replaces=k1_tpu,
             path="real-size pagerank", **k1_real),
        dict(name="hot_gather", route="cuda", source=source, replaces=k1_tpu,
             path="mind serve cache", **k1_cache),
        dict(name="hot_gather", route="cuda", source=source, replaces=k1_tpu,
             path="mind serve_scores hot", **k1_dense),
        dict(name="hot_gather", route="cuda", source=source, replaces=k1_tpu,
             path="real-size pagerank-delta", **k1_prd),
        dict(name="hot_gather", route="cuda", source=source, replaces=k1_tpu,
             path="gnn serve cache", **k1_gnn),
        dict(name="gather_segsum", route="cuda", source=source,
             replaces="src/repro/kernels/hot_gather/hot_gather.py:58",
             path="aligned pull sum", **k2),
        dict(name="hot_bag", route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
             replaces="src/repro/kernels/embedding_bag/embedding_bag.py:20",
             path="mind bag (serve_bulk)", **k3),
        dict(name="relax_min", route="cuda", source="src/repro_torch/csrc/segment_min.cu",
             replaces="none: the JAX package relaxes with a gather, where and XLA's "
                      "jax.ops.segment_min",
             path=f"sssp on kron {REAL_SCALE}", **sm),
    ]
    # the gateway after the other paths' kernel timing: its busy share is
    # read under torch.profiler, as training's is
    k1_gateway = phase("13 (the gateway and chaos over MIND serving)", run_gateway, dev, params)
    kernels.insert(6, dict(name="hot_gather", route="cuda", source=source, replaces=k1_tpu,
                           path="mind gateway", **k1_gateway))
    # the earlier phases' K1 tensors go before PNA's 32 GiB forward
    del k1_mix, dense_mix, cache_mix, gnn_mix
    torch.cuda.empty_cache()
    kernels[7:7] = phase("17 (PNA over a whole graph)", run_pna_whole_graph, dev)
    kernels += phase("18 (the segment sum at the PRD cells' shapes)", run_segment_sum, dev)
    kernels += phase("19 (GAT over a whole graph)", run_gat_whole_graph, dev)
    kernels += phase("20 (DeeperGCN over a whole graph)", run_deepergcn_whole_graph, dev)
    if any(k["launches"] < 1 for k in kernels):
        fail("a kernel's path did not launch it")
    # training runs after the kernels' timing: after its profiled fit,
    # torch.profiler on the card lost 2 of every 20 kernels in each window
    phase("11 (training)", run_training, dev, params, real_graph)
    # the earlier phases' tensors on the card go before the 22-34 GB message
    # tensors of phase 12
    del params
    torch.cuda.empty_cache()
    phase("12 (GRASP-partitioned GIN training)", run_grasp_training, dev, real_graph, qs_graph)
    # the LMs' float32 weights (31 GB for minitron-8b) after every earlier
    # phase's tensors are gone
    del real_graph, qs_graph
    torch.cuda.empty_cache()
    phase("14 (LM serving)", run_lm_serving, dev)
    torch.cuda.empty_cache()
    phase("15 (LM training)", run_lm_training, dev)
    torch.cuda.empty_cache()
    phase("16 (the mesh and sharding layer)", run_mesh, dev)
    print(json.dumps({"kernels": kernels}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
