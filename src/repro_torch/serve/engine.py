"""Serving engines: cache + scheduler wired to the nn forward paths.

``RecsysServeEngine`` serves MIND candidate-scoring requests: history and
candidate item embeddings are gathered through the GRASP
``EmbeddingCache`` (hot rows by K1 on the device) and fed to the shared
capsule-routing math (``nn.recsys.user_interests_from_emb`` /
``score_candidates``). Partial batches are padded up to ``max_batch``
*after* the cache lookup, so the forward sees one shape while the cache
only ever sees real references.

``GNNServeEngine`` serves node-classification requests: seed nodes are
expanded by the fanout sampler, node features are gathered through the
cache (degree-ordered table => hot prefix = high-degree nodes, the paper's
High Reuse Region, read by K1 on the device), and the GIN forward runs on
the padded block graph. Its partial batches are padded with seed node 0
*before* sampling, as in the JAX package, so the pad seeds' blocks go
through the cache too.

``LMServeEngine`` serves greedy generation: prompts are clipped and
left-padded to one ``(max_batch, prefill)`` shape, prefilled into a KV
cache and decoded token by token (``nn.transformer``); ``lm_loop`` is the
serve CLI's batched prefill+decode loop over Zipf prompts.

``run_recsys_stream`` drives a full closed-loop run on a zipf request
stream against a virtual clock — the entry point the serve CLI uses.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import devices
from repro_torch.configs import base as cfgs
from repro_torch.configs.base import GNNConfig, RecsysConfig
from repro_torch.data.pipeline import zipf_ids
from repro_torch.graph import sampler
from repro_torch.nn import gnn as gnn_mod
from repro_torch.nn import recsys as recsys_mod
from repro_torch.nn import transformer as tfm
from repro_torch.serve.cache import CacheConfig, EmbeddingCache
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import (
    ContinuousBatcher,
    Request,
    SchedulerConfig,
    VirtualClock,
)


def _pad_batch(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the batch dim to ``width``."""
    if x.shape[0] >= width:
        return x
    return torch.cat([x, x.new_zeros((width - x.shape[0],) + tuple(x.shape[1:]))])


class _EngineBase:
    """Shared continuous-batching pump.

    ``step`` claims a batch, runs ``forward``, and — when the scheduler
    clock is a ``VirtualClock`` — advances it by the measured forward wall
    time (or a deterministic ``service_model(batch_size)``) before
    completion, so virtual-time latency accounting includes service time.
    ``forward`` returns host arrays, so the device has finished the batch
    before ``step`` reads the clock.
    """

    batcher: ContinuousBatcher
    service_model = None  # Optional[Callable[[int], float]]

    def submit(self, payload: Dict, deadline_s: Optional[float] = None) -> Request:
        return self.batcher.submit(payload, deadline_s)

    def forward(self, payloads: List[Dict]) -> np.ndarray:
        raise NotImplementedError

    def step(self) -> int:
        """Run one continuous-batching iteration; returns batch size."""
        batch = self.batcher.next_batch()
        if not batch:
            return 0
        t0 = time.perf_counter()
        results = self.forward([r.payload for r in batch])
        dt = time.perf_counter() - t0
        clock = self.batcher.clock
        if isinstance(clock, VirtualClock):
            if self.service_model is not None:
                dt = self.service_model(len(batch))
            clock.advance(dt)
        self.batcher.complete(batch, list(results))
        return len(batch)

    def run_until_idle(self) -> None:
        while self.step():
            pass


class RecsysServeEngine(_EngineBase):
    """MIND candidate scoring over the GRASP embedding cache.

    Request payload: ``{"hist": (H,), "hist_mask": (H,), "candidates":
    (C,)}``; result: ``(C,)`` float32 scores. ``params`` must hold a dense
    ``items`` table — the cache becomes the only reader of it (a host copy
    is its backing store). The rest of ``params`` and the cache's blocks
    are placed on ``device``.
    """

    def __init__(
        self,
        params: Dict,
        cfg: RecsysConfig,
        cache_config: CacheConfig,
        sched_config: SchedulerConfig,
        metrics: Optional[ServeMetrics] = None,
        clock=time.monotonic,
        service_model=None,
        device: str | torch.device = devices.DEFAULT_DEVICE,
    ) -> None:
        self.device = devices.resolve(device)
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.params = recsys_mod.to_device(
            {k: v for k, v in params.items() if k != "items"}, self.device)
        self.cache = EmbeddingCache(
            params["items"].cpu().numpy(), cache_config, metrics=self.metrics,
            device=self.device,
        )
        self.batcher = ContinuousBatcher(sched_config, clock=clock,
                                         metrics=self.metrics)
        self._width = sched_config.max_batch
        self.service_model = service_model

    def _routed(self, e, hist, mask, cand_e) -> torch.Tensor:
        interests = recsys_mod.user_interests_from_emb(self.params, self.cfg, e, hist, mask)
        return recsys_mod.score_candidates(interests, cand_e)

    def forward(self, payloads: List[Dict]) -> np.ndarray:
        """Score a list of request payloads; returns (n, C)."""
        n = len(payloads)
        # normalize dtypes so decoded payloads (int64 lists) take the same path
        hist = np.stack([p["hist"] for p in payloads]).astype(np.int32)
        cand = np.stack([p["candidates"] for p in payloads]).astype(np.int32)
        mask = np.stack([p["hist_mask"] for p in payloads]).astype(bool)
        # the looked-up rows stay on the device (the JAX engine copied them
        # device -> host -> device to pad the batch)
        e, _ = self.cache.lookup(hist.reshape(-1))
        ce, _ = self.cache.lookup(cand.reshape(-1))
        w, d, dev = self._width, self.cache.dim, self.device
        scores = self._routed(
            _pad_batch(e.reshape(hist.shape + (d,)), w),
            _pad_batch(torch.from_numpy(hist).to(dev), w),
            _pad_batch(torch.from_numpy(mask).to(dev), w),
            _pad_batch(ce.reshape(cand.shape + (d,)), w),
        )
        return scores[:n].cpu().numpy()   # waits for the device

    def warmup(self, candidates: int) -> None:
        """Run the forward once at the canonical batch shape without
        touching the cache or metrics (library handles, allocator pools)."""
        w, h, d, dev = self._width, self.cfg.hist_len, self.cache.dim, self.device
        self._routed(
            torch.zeros((w, h, d), device=dev),
            torch.zeros((w, h), dtype=torch.int32, device=dev),
            torch.zeros((w, h), dtype=torch.bool, device=dev),
            torch.zeros((w, candidates, d), device=dev),
        ).cpu()


class GNNServeEngine(_EngineBase):
    """GIN node-classification serving over a cached node-feature table.

    Request payload: ``{"seeds": (S,)}`` with exactly ``seeds_per_req``
    seed node ids; result: ``(S, d_out)`` logits. The feature table is
    degree-ordered so the cache's pinned prefix covers the hub nodes every
    sampled block touches; the pinned region is capped at the graph's
    hot-vertex count (out-degree >= average). ``features`` stays on the
    host as the cache's backing store; ``params`` and the cache's blocks
    are placed on ``device``. Sampling draws from the engine's own
    ``np.random.default_rng(seed)``.
    """

    def __init__(
        self,
        params: Dict,
        cfg: GNNConfig,
        graph,                       # graph.csr.CSR, degree-ordered ids
        features: np.ndarray,        # (N, F) node-feature table
        cache_config: CacheConfig,
        sched_config: SchedulerConfig,
        fanout=(5, 5),
        seeds_per_req: int = 4,
        metrics: Optional[ServeMetrics] = None,
        clock=time.monotonic,
        seed: int = 0,
        service_model=None,
        device: str | torch.device = devices.DEFAULT_DEVICE,
    ) -> None:
        self.device = devices.resolve(device)
        self.cfg = cfg
        self.graph = graph
        self.fanout = tuple(fanout)
        self.seeds_per_req = seeds_per_req
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.params = gnn_mod.to_device(params, self.device)
        self.cache = EmbeddingCache(
            features, cache_config,
            degree=np.asarray(graph.out_degree), metrics=self.metrics, device=self.device,
        )
        self.batcher = ContinuousBatcher(sched_config, clock=clock,
                                         metrics=self.metrics)
        self._width = sched_config.max_batch
        self._rng = np.random.default_rng(seed)
        self.service_model = service_model

    def forward(self, payloads: List[Dict]) -> np.ndarray:
        """Logits of a list of request payloads; returns (n, S, d_out)."""
        n = len(payloads)
        seeds = np.concatenate([np.asarray(p["seeds"]) for p in payloads])
        pad_seeds = (self._width - n) * self.seeds_per_req
        if pad_seeds:
            seeds = np.pad(seeds, (0, pad_seeds))  # node 0: hottest, harmless
        blocks = sampler.sample_blocks(self.graph, seeds, self.fanout, self._rng)
        logits = self.forward_blocks(blocks)
        per_req = logits[: n * self.seeds_per_req]
        return per_req.reshape(n, self.seeds_per_req, -1)

    def forward_blocks(self, blocks: sampler.SampledBlocks) -> np.ndarray:
        """Seed-node logits for one sampled block graph (cache-fed gather)."""
        dev = self.device
        x, _ = self.cache.lookup(blocks.node_ids)
        x = torch.where(torch.from_numpy(blocks.node_mask).to(dev)[:, None], x, 0.0)
        batch = {
            "x": x,
            "src": torch.from_numpy(blocks.src).to(dev),
            "dst": torch.from_numpy(blocks.dst).to(dev),
            "emask": torch.from_numpy(blocks.emask).to(dev),
        }
        out = gnn_mod.apply(self.params, self.cfg, batch)
        seeds = torch.from_numpy(blocks.seeds_local).to(dev)
        return out.index_select(0, seeds).cpu().numpy()   # waits for the device


def _lm_config(arch: str, smoke: bool):
    cfg = cfgs.get_arch(arch)
    return cfgs.reduced(cfg) if smoke else cfg


def _greedy(params, cfg, tokens: torch.Tensor, max_len: int, steps: int) -> torch.Tensor:
    """(w, prefill) prompts on the params' device -> (w, steps) greedy
    continuation, still on the device: prefill, then ``steps - 1`` decode
    steps, each feeding back the first maximum of its logits (as
    ``jnp.argmax``)."""
    logits, cache = tfm.prefill(params, cfg, tokens, max_len=max_len)
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = tfm.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


class LMServeEngine(_EngineBase):
    """Transformer prefill+decode serving behind the continuous batcher.

    Request payload: ``{"tokens": (<=prefill,) int prompt ids}``; result:
    ``(decode,)`` int32 greedily-decoded ids. Prompts are clipped to the
    last ``prefill`` tokens and to ``vocab - 1``, and left-padded with
    token 0, so every batch has one ``(max_batch, prefill)`` shape.
    ``params`` (the ``nn.transformer`` tree, e.g. from
    ``convert.lm_params_from_numpy``) are placed on ``device``; by default
    they are drawn from seed 0 on ``device``. The forward ends in one host
    copy of the tokens.
    """

    def __init__(
        self,
        arch: str = "minitron-8b",
        smoke: bool = True,
        sched_config: Optional[SchedulerConfig] = None,
        prefill: int = 64,
        decode: int = 32,
        params: Optional[Dict] = None,
        metrics: Optional[ServeMetrics] = None,
        clock=time.monotonic,
        service_model=None,
        device: str | torch.device = devices.DEFAULT_DEVICE,
    ) -> None:
        self.device = devices.resolve(device)
        self.cfg = _lm_config(arch, smoke)
        self.prefill_len = int(prefill)
        self.decode_len = int(decode)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        sched_config = sched_config if sched_config is not None else SchedulerConfig()
        self.batcher = ContinuousBatcher(sched_config, clock=clock,
                                         metrics=self.metrics)
        self._width = sched_config.max_batch
        self.service_model = service_model
        self.params = (tfm.to_device(params, self.device) if params is not None
                       else tfm.init(torch.Generator(device=self.device).manual_seed(0), self.cfg,
                                     device=self.device))

    def _generate(self, tokens: np.ndarray) -> np.ndarray:
        """(w, prefill) int32 -> (w, decode) int32 greedy continuation."""
        out = _greedy(self.params, self.cfg, torch.from_numpy(tokens).to(self.device),
                      self.prefill_len + self.decode_len, self.decode_len)
        return out.cpu().numpy()   # waits for the device

    def forward(self, payloads: List[Dict]) -> np.ndarray:
        n = len(payloads)
        toks = np.zeros((self._width, self.prefill_len), np.int32)
        for i, p in enumerate(payloads):
            t = np.asarray(p["tokens"], np.int32).ravel()[-self.prefill_len:]
            t = np.clip(t, 0, self.cfg.vocab - 1)
            toks[i, self.prefill_len - t.size:] = t
        out = self._generate(toks)
        self.metrics.count("tokens_generated", n * self.decode_len)
        return out[:n]

    def warmup(self) -> None:
        """Run prefill+decode once at the canonical batch shape (library
        handles, allocator pools) without touching metrics."""
        self._generate(np.zeros((self._width, self.prefill_len), np.int32))


# ---------------------------------------------------------------------------
# LM prefill+decode loop (the serve CLI's --engine lm)
# ---------------------------------------------------------------------------
def lm_loop(arch: str = "starcoder2-7b", smoke: bool = True, requests: int = 16,
            batch: int = 8, prefill: int = 64, decode: int = 32,
            device: str | torch.device = devices.DEFAULT_DEVICE) -> Dict:
    """Batched prefill+decode serving loop for the transformer archs, on
    ``device`` with parameters drawn from seed 0 there.

    Prompts are Zipf ids from ``np.random.default_rng(0)``. The final
    batch computes exactly the remaining ``n`` sequences and the report
    counts only tokens actually served, so a partial batch does not
    inflate tok/s or batch latency with padded work. Each batch's latency
    ends with the host copy of its tokens.
    """
    dev = devices.resolve(device)
    cfg = _lm_config(arch, smoke)
    rng = np.random.default_rng(0)
    params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)

    done, toks_served, t0 = 0, 0, time.perf_counter()
    lat = []
    while done < requests:
        n = min(batch, requests - done)
        tokens = zipf_ids(rng, (n, prefill), cfg.vocab)
        t1 = time.perf_counter()
        _greedy(params, cfg, torch.from_numpy(tokens).to(dev), prefill + decode,
                decode).cpu()
        lat.append(time.perf_counter() - t1)
        done += n
        toks_served += n * decode
    dt = time.perf_counter() - t0
    stats = {
        "requests": requests,
        "tokens": toks_served,
        "tok_s": toks_served / dt,
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
    }
    print(f"[serve] {requests} requests, {toks_served} tokens in {dt:.2f}s "
          f"({stats['tok_s']:.1f} tok/s); batch latency p50="
          f"{stats['p50_ms']:.0f}ms p99={stats['p99_ms']:.0f}ms")
    return stats


# ---------------------------------------------------------------------------
# Closed-loop zipf request stream (the CLI's loop)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StreamConfig:
    requests: int = 256
    qps: float = 2000.0            # offered load (virtual-time arrivals)
    candidates: int = 32
    zipf_a: float = 1.1
    deadline_s: Optional[float] = 0.05
    seed: int = 0


def stream_payloads(cfg: RecsysConfig, stream: StreamConfig) -> List[Dict]:
    """The stream's request payloads: zipf histories (all positions kept) and
    zipf candidates, drawn from ``stream.seed``."""
    rng = np.random.default_rng(stream.seed)
    payloads = []
    for _ in range(stream.requests):
        hist = zipf_ids(rng, (cfg.hist_len,), cfg.n_items, a=stream.zipf_a)
        cand = zipf_ids(rng, (stream.candidates,), cfg.n_items, a=stream.zipf_a)
        payloads.append({
            "hist": hist,
            "hist_mask": np.ones(cfg.hist_len, bool),
            "candidates": cand,
        })
    return payloads


def run_recsys_stream(
    cfg: RecsysConfig,
    cache_config: CacheConfig,
    sched_config: SchedulerConfig,
    stream: StreamConfig,
    params: Optional[Dict] = None,
    service_time_s: Optional[float] = None,
    device: str | torch.device = devices.DEFAULT_DEVICE,
) -> Dict:
    """Drive a zipf-skewed request stream through a fresh engine on ``device``.

    Arrivals follow a deterministic uniform process at ``stream.qps`` on a
    virtual clock; each batch advances the clock by the *measured* forward
    wall time (or ``service_time_s`` for fully deterministic runs). Returns
    the metrics snapshot, including cache hit rates and latency tails.
    ``params`` defaults to ``nn.recsys.init`` from seed 0, made on the host:
    the engine moves what the forward needs to ``device``, and the table
    stays on the host as the cache's backing store.
    """
    dev = devices.resolve(device)
    if params is None:
        params = recsys_mod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    clock = VirtualClock()
    service_model = (None if service_time_s is None
                     else (lambda n: service_time_s))
    engine = RecsysServeEngine(params, cfg, cache_config, sched_config,
                               clock=clock, service_model=service_model, device=dev)
    arrivals = np.arange(stream.requests) / stream.qps
    payloads = stream_payloads(cfg, stream)

    i = 0
    while i < stream.requests or engine.batcher.depth:
        while i < stream.requests and arrivals[i] <= clock():
            engine.submit(payloads[i], deadline_s=stream.deadline_s)
            i += 1
        if not engine.batcher.depth:
            clock.advance_to(arrivals[i])
            continue
        engine.step()
    snap = engine.metrics.snapshot()
    snap["config"] = {
        "budget_bytes": cache_config.budget_bytes,
        "hot_fraction": cache_config.hot_fraction,
        "policy": cache_config.policy,
        "hot_size": engine.cache.hot_size,
        "cold_slots": engine.cache.cold_slots,
        "max_batch": sched_config.max_batch,
        "max_queue": sched_config.max_queue,
        "qps": stream.qps,
        "deadline_s": stream.deadline_s,
        "requests": stream.requests,
    }
    return snap
