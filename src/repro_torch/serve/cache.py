"""GRASP-managed two-region embedding cache (the serving tier).

The paper pins the High Reuse Region of the Property Array against
thrashing and leaves the rest of the cache flexible. A production
embedding-serving cache has exactly that structure, realised in software:

  hot region   the leading ``hot_size`` rows of the popularity/degree-
               ordered table, permanently device-resident ("pinned" — no
               eviction can touch them). Batched reads go through the
               hot-gather kernel (K1), whose hot-row loads carry an L2
               ``evict_last`` hint.
  cold region  ``cold_slots`` flexible rows managed by an RRPV scheme
               mirroring ``core.policies``: SRRIP insertion at RRPV=6,
               hit promotion to MRU, victim = aged max-RRPV slot. With a
               ``GraspPlan`` attached, insertion/promotion follow the
               paper's Table II instead (Moderate->6 with gradual
               promotion, Low->7), so tail rows cannot displace the
               Moderate Reuse Region.

Sizing comes from a *byte* budget via ``core.plan.entries_for_budget``,
split between the regions by ``hot_fraction``. ``hot_fraction=0``
disables pinning entirely and yields the unpinned RRPV/LRU baselines.

Metadata (slot maps, RRPV counters, LRU stamps) lives on the host as numpy
and is the JAX package's bit for bit; row data lives on an explicit
``device``. ``lookup`` is batched: unique cold misses are fetched from the
backing table once and scattered into the cold block, so duplicate ids
inside one batch cost one fill.

Victim selection for a batch of k misses exploits that RRPV aging adds the
*same* delta to every slot, so relative order never changes: in "deficit"
keys (``RRPV_MAX - rrpv``) the sequential evict loop is exactly repeated
extract-min (first index on ties) with re-insertion at ``min + 1``, which
a short per-level loop computes without per-miss Python. LRU victims are a
stable argsort of the timestamps. Both reproduce the retained reference
loop (``serve.refcache``) bit for bit.

Copies between host and device: a lookup copies its index stream to the
device once for K1, and only the rows K1 does not read (cold hits from the
host mirror of the cold block, and bypassed rows from the backing table)
go host->device; the hot rows never leave the device, and the result stays
there for the engine's forward. The JAX package instead brought the
kernel's rows back to the host and assembled the batch there.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import devices
from repro_torch.core import hotset
from repro_torch.core import plan as plan_mod
from repro_torch.core.policies import RRPV_LONG, RRPV_MAX
from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part
from repro_torch.serve.metrics import ServeMetrics

# bump on any change to the snapshot layout; restore refuses other versions
SNAPSHOT_VERSION = 1


class SnapshotError(ValueError):
    """Snapshot rejected: wrong version, shape mismatch, or bad checksum."""


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    budget_bytes: int          # total device budget for both regions
    hot_fraction: float = 0.5  # share of budget pinned; 0 => unpinned baseline
    policy: str = "rrpv"       # cold-region scheme: "rrpv" | "lru"
    use_kernel: bool = True    # K1 (hot_gather) for the pinned region


@dataclasses.dataclass(frozen=True)
class LookupStats:
    hot_hits: int = 0
    cold_hits: int = 0
    misses: int = 0     # unique fills + bypassed references
    bypassed: int = 0   # references served straight from the backing store

    @property
    def total(self) -> int:
        return self.hot_hits + self.cold_hits + self.misses

    @property
    def hit_rate(self) -> float:
        return (self.hot_hits + self.cold_hits) / self.total if self.total else 0.0


class EmbeddingCache:
    """Two-region device cache over a popularity-ordered embedding table.

    ``table`` (N, d) float32 is the backing store, on the host (row order
    = descending expected reuse, the DBG/popularity layout every other tier
    of this repo assumes). ``degree`` optionally caps the pinned region at
    the paper's hot-vertex count (degree >= average) so a huge budget never
    pins provably-cold rows. ``plan`` switches the cold region from plain
    SRRIP to GRASP Table II hint-steered insertion/promotion. The hot and
    cold blocks, and every lookup's result, lie on ``device``.
    """

    def __init__(
        self,
        table: np.ndarray,
        config: CacheConfig,
        degree: Optional[np.ndarray] = None,
        plan: Optional[plan_mod.GraspPlan] = None,
        metrics: Optional[ServeMetrics] = None,
        device: str | torch.device = devices.DEFAULT_DEVICE,
    ) -> None:
        self.device = devices.resolve(device)
        table = np.ascontiguousarray(np.asarray(table, np.float32))
        if table.ndim != 2:
            raise ValueError("table must be (N, d)")
        self.table = table
        self.num_rows, self.dim = table.shape
        self.row_bytes = self.dim * table.itemsize
        self.config = config
        self.plan = plan
        self.metrics = metrics if metrics is not None else ServeMetrics()

        capacity = plan_mod.entries_for_budget(
            config.budget_bytes, self.row_bytes, max_entries=self.num_rows
        )
        hot = 0
        if config.hot_fraction > 0:
            hot = plan_mod.entries_for_budget(
                int(config.budget_bytes * config.hot_fraction),
                self.row_bytes,
                max_entries=capacity,
            )
            if degree is not None:
                # never pin more rows than are actually hot (paper Sec. II-A)
                hot = min(hot, int(hotset.hot_mask(np.asarray(degree)).sum()))
        self.hot_size = int(hot)
        self.cold_slots = int(capacity - hot)
        # NB: no plan is attached by default. Measured on the zipf smoke
        # stream, Table II hint-steered cold insertion *loses* to plain
        # SRRIP here (~-2pt hit rate): the clamped tail id carries real
        # mass but classifies as Low and thrashes at RRPV=7. Matches the
        # paper's own point — pin the hot region, keep the rest flexible.

        # --- device-resident row data ---------------------------------
        # the hot block is (hot_size, d): K1 takes any d, so no lane padding
        if self.hot_size > 0:
            self._hot_block = torch.tensor(table[: self.hot_size], device=self.device)
        else:
            self._hot_block = None
        self._cold_rows = torch.zeros((max(self.cold_slots, 1), self.dim),
                                      dtype=torch.float32, device=self.device)
        # host mirror of the cold block: batch assembly reads this instead
        # of round-tripping the whole device cold region per lookup. The
        # device copy is refreshed lazily (one transfer) via
        # ``cold_rows_device``
        self._cold_rows_host = np.zeros((max(self.cold_slots, 1), self.dim),
                                        np.float32)
        self._cold_rows_dirty = False

        # --- host-side cold-region metadata ---------------------------
        cs = self.cold_slots
        self._slot_id = np.full(cs, -1, np.int64)        # slot -> row id
        self._slot_rrpv = np.full(cs, RRPV_MAX, np.int64)
        self._slot_ts = np.zeros(cs, np.int64)           # LRU timestamps
        self._id_slot = np.full(self.num_rows, -1, np.int64)
        self._clock = 0
        self._resident = 0               # occupied cold slots, incremental

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.hot_size + self.cold_slots

    @property
    def pin_ratio(self) -> float:
        return self.hot_size / self.capacity if self.capacity else 0.0

    def _hint(self, rid: int) -> int:
        """2-bit GRASP reuse hint for a row id (0 hot / 1 moderate / 2 low)."""
        if self.plan is None:
            return 3  # "default" — plain SRRIP handling
        return int(self.plan.classify_elem(np.int64(rid)))

    def _insert_rrpv(self, rid: int) -> int:
        h = self._hint(rid)
        if h == 1:
            return RRPV_LONG
        if h == 2:
            return RRPV_MAX
        return RRPV_LONG  # SRRIP default insertion

    def _promote(self, slots: np.ndarray) -> None:
        if self.config.policy == "lru":
            self._slot_ts[slots] = self._clock
            return
        if self.plan is None:
            self._slot_rrpv[slots] = 0
            return
        # GRASP Table II: Moderate/Low hits promote gradually (decrement)
        hints = self.plan.classify_elem(self._slot_id[slots])
        grad = np.maximum(self._slot_rrpv[slots] - 1, 0)
        self._slot_rrpv[slots] = np.where(hints >= 1, grad, 0)
        self._slot_ts[slots] = self._clock

    def _evict_one(self) -> int:
        """Pick a victim slot (cold region only — hot rows are pinned)."""
        if self.config.policy == "lru":
            return int(np.argmin(self._slot_ts))
        mx = self._slot_rrpv.max()
        if mx < RRPV_MAX:
            self._slot_rrpv += RRPV_MAX - mx  # age the whole region
        return int(np.argmax(self._slot_rrpv))

    def _insert_one(self, rid: int) -> int:
        """Sequential insert (the reference semantics; used when a GraspPlan
        steers per-id insertion RRPVs, where victim choice depends on the
        id stream order and cannot be batched)."""
        v = self._evict_one()
        old = self._slot_id[v]
        if old >= 0:
            self._id_slot[old] = -1
        else:
            self._resident += 1
        self._slot_id[v] = rid
        self._id_slot[rid] = v
        self._slot_rrpv[v] = self._insert_rrpv(int(rid))
        self._slot_ts[v] = self._clock
        return v

    # --- batched victim selection (bit-equal to the _evict_one loop) ---
    def _select_victims_rrpv(self, k: int) -> np.ndarray:
        """k RRPV victims in eviction order, without per-miss Python.

        Aging adds one uniform delta to every slot, so relative order is
        invariant: in absolute "deficit" keys (RRPV_MAX - rrpv, plus total
        aging so far) the sequential loop is exactly: repeatedly take the
        minimum key (first index on ties), re-inserting the victim at
        min + 1 (SRRIP insertion, one step from eviction). All slots tied
        at the current minimum are consumed in index order before the
        level rises, so one numpy step per *level* — not per miss —
        replays the loop exactly, re-evictions of same-batch fills
        included.
        """
        cur = (RRPV_MAX - self._slot_rrpv).astype(np.int64)  # absolute keys
        victims = np.empty(k, np.int64)
        got, level = 0, np.int64(0)
        while got < k:
            level = cur.min()
            cand = np.flatnonzero(cur == level)
            t = min(cand.size, k - got)
            victims[got:got + t] = cand[:t]
            cur[cand[:t]] = level + 1
            got += t
        # fold the accumulated aging back into stored RRPVs: final deficit
        # of every slot is its key minus the last extraction level
        self._slot_rrpv[:] = RRPV_MAX - (cur - level)
        return victims

    def _select_victims_lru(self, k: int) -> np.ndarray:
        """k LRU victims in eviction order: slots not touched this lookup,
        oldest first (stable sort = argmin's first-index tie-break). Once
        every slot carries the current clock, argmin degenerates to slot 0
        — same as the sequential loop."""
        order = np.argsort(self._slot_ts, kind="stable")
        stale = order[self._slot_ts[order] < self._clock]
        # beyond the stale set every slot holds the current clock, where
        # argmin (= the sequential victim) is always slot 0 — the zeros
        t = min(stale.size, k)
        victims = np.zeros(k, np.int64)
        victims[:t] = stale[:t]
        return victims

    def _apply_inserts(self, victims: np.ndarray, rids: np.ndarray) -> None:
        """Batched metadata update for inserting rids[i] -> victims[i] in
        order. When a slot repeats within the batch (more misses than the
        eviction dynamics keep resident), the LAST rid wins and every
        earlier same-batch rid ends displaced — exactly the sequential
        outcome."""
        k = victims.size
        uniq_slots, rev_idx = np.unique(victims[::-1], return_index=True)
        last_idx = k - 1 - rev_idx           # last occurrence of each slot
        old = self._slot_id[uniq_slots]
        self._resident += int((old < 0).sum())
        self._id_slot[old[old >= 0]] = -1    # pre-batch occupants out
        displaced = np.ones(k, bool)
        displaced[last_idx] = False
        self._id_slot[rids[displaced]] = -1  # same-batch displaced stay out
        winners = rids[last_idx]
        self._slot_id[uniq_slots] = winners
        self._id_slot[winners] = uniq_slots
        if self.config.policy == "lru":
            # rrpv aging/insertion already folded in by _select_victims_rrpv
            # on the rrpv path; LRU only stamps the insertion value
            self._slot_rrpv[victims] = RRPV_LONG
        self._slot_ts[victims] = self._clock

    def _fill_rows(self, victims: np.ndarray, rids: np.ndarray) -> None:
        """One batched backing-store gather into the host mirror for a
        batch of fills; re-used slots keep only their final occupant's
        row. The device copy is invalidated, not written — lookup serves
        from the mirror, so the device block is only materialized when a
        device consumer asks for it."""
        k = victims.size
        uniq_slots, rev_idx = np.unique(victims[::-1], return_index=True)
        winners = rids[k - 1 - rev_idx]
        self._cold_rows_host[uniq_slots] = self.table[winners]
        self._cold_rows_dirty = True

    def cold_rows_device(self) -> torch.Tensor:
        """The cold block as a device tensor, refreshed from the host
        mirror in one copy when fills have made it stale."""
        if self._cold_rows_dirty:
            self._cold_rows = torch.tensor(self._cold_rows_host, device=self.device)
            self._cold_rows_dirty = False
        return self._cold_rows

    # ------------------------------------------------------------------
    def lookup(self, ids) -> Tuple[torch.Tensor, LookupStats]:
        """Batched read: (B,) int ids -> ((B, d) float32 on the device, LookupStats).

        The result always equals ``table[ids]`` — the cache changes where
        rows are read from, never their values.
        """
        ids = np.asarray(ids, np.int64).reshape(-1)
        b = ids.shape[0]
        if b == 0:
            # empty batch: no clock tick, no metadata churn — just an
            # all-zero LookupStats and the gauges
            return self._finish(torch.zeros((0, self.dim), dtype=torch.float32,
                                            device=self.device), LookupStats())
        if ids.min() < 0 or ids.max() >= self.num_rows:
            raise IndexError("id out of range")
        self._clock += 1
        hot_mask = ids < self.hot_size
        hot_hits = int(hot_mask.sum())

        cold_ids = ids[~hot_mask]
        uniq = np.unique(cold_ids)
        n_fill = 0
        if uniq.size:
            resident = self._id_slot[uniq] >= 0
            hit_slots = self._id_slot[uniq[resident]]
            if hit_slots.size:
                self._promote(hit_slots)
            miss_ids = uniq[~resident]
            if miss_ids.size and self.cold_slots > 0:
                n_fill = int(miss_ids.size)
                if self.plan is None:
                    if self.config.policy == "lru":
                        victims = self._select_victims_lru(n_fill)
                    else:
                        victims = self._select_victims_rrpv(n_fill)
                    self._apply_inserts(victims, miss_ids)
                else:
                    victims = np.fromiter(
                        (self._insert_one(int(r)) for r in miss_ids),
                        np.int64, n_fill)
                self._fill_rows(victims, miss_ids)

        # --- assemble the batch: host rows, then the hot rows via K1 ---
        kernel = self.hot_size > 0 and hot_hits > 0 and self.config.use_kernel
        out = np.zeros((b, self.dim), np.float32)
        if self.hot_size > 0 and hot_hits and not kernel:
            # the backing table IS the hot block: a pure host gather, no
            # device->host copy of the pinned region
            out[hot_mask] = self.table[ids[hot_mask]]
        cold_mask = ~hot_mask
        slots = np.where(cold_mask, self._id_slot[ids], -1)
        served = cold_mask & (slots >= 0)
        if served.any():
            out[served] = self._cold_rows_host[slots[served]]
        byp = cold_mask & (slots < 0)
        if byp.any():
            out[byp] = self.table[ids[byp]]

        if kernel:
            rows = self._gather_hot(ids, hot_mask)
            rest = np.flatnonzero(cold_mask)
            if rest.size:  # only the rows K1 did not read cross to the device
                rows.index_copy_(0, torch.from_numpy(rest).to(self.device),
                                 torch.from_numpy(out[rest]).to(self.device))
        else:
            rows = torch.from_numpy(out).to(self.device)

        byp_refs = int(byp.sum())
        misses = n_fill + byp_refs
        cold_hits = int(cold_mask.sum()) - misses
        stats = LookupStats(hot_hits=hot_hits, cold_hits=cold_hits,
                            misses=misses, bypassed=byp_refs)
        return self._finish(rows, stats)

    def _finish(self, out: torch.Tensor, stats: LookupStats):
        m = self.metrics
        m.count("hot_hits", stats.hot_hits)
        m.count("cold_hits", stats.cold_hits)
        m.count("misses", stats.misses)
        m.count("bypassed", stats.bypassed)
        m.gauge("pin_ratio", self.pin_ratio)
        m.gauge("cold_resident", self._resident)
        return out, stats

    def _gather_hot(self, ids: np.ndarray, hot_mask: np.ndarray) -> torch.Tensor:
        """(B, d) on the device: the hot references' rows read from the
        pinned block by one K1 launch, zero rows everywhere else."""
        idx = np.where(hot_mask, ids, -1).astype(np.int32)  # misses -> 0 rows
        return hot_gather_hot_part(self._hot_block, torch.from_numpy(idx).to(self.device))

    # -- warm-restart snapshots ----------------------------------------
    def _snapshot_checksum(self, geometry: Dict, state: Dict) -> int:
        """crc32 over the canonical byte serialization of the snapshot
        payload — cheap, and plenty to catch truncated/garbled files."""
        blob = json.dumps({"geometry": geometry, "state": state},
                          sort_keys=True).encode()
        return zlib.crc32(blob) & 0xFFFFFFFF

    def snapshot(self) -> Dict:
        """Serialize the cache's *learned* state: which rows are resident
        where, and the recency/RRPV metadata that took a whole request
        stream to converge. Row data is NOT serialized — the backing table
        is the source of truth, so restore re-gathers resident rows from
        it (one batched fill) and the hot region rebuilds from the table
        prefix. Version-stamped and checksummed; restore validates both.
        """
        geometry = {
            "num_rows": self.num_rows,
            "dim": self.dim,
            "hot_size": self.hot_size,
            "cold_slots": self.cold_slots,
            "policy": self.config.policy,
        }
        state = {
            "slot_id": self._slot_id.tolist(),
            "slot_rrpv": self._slot_rrpv.tolist(),
            "slot_ts": self._slot_ts.tolist(),
            "clock": int(self._clock),
        }
        return {
            "version": SNAPSHOT_VERSION,
            "geometry": geometry,
            "state": state,
            "checksum": self._snapshot_checksum(geometry, state),
        }

    def restore(self, snap: Dict) -> None:
        """Rebuild hot-set/cold-region state from ``snapshot()`` output.

        Raises ``SnapshotError`` on version/geometry/checksum mismatch —
        a stale or corrupt snapshot must fall back to a cold start, never
        poison a running cache with inconsistent metadata.
        """
        if not isinstance(snap, dict) or snap.get("version") != SNAPSHOT_VERSION:
            raise SnapshotError(
                f"snapshot version {snap.get('version') if isinstance(snap, dict) else snap!r} "
                f"!= {SNAPSHOT_VERSION}")
        geometry, state = snap.get("geometry", {}), snap.get("state", {})
        if snap.get("checksum") != self._snapshot_checksum(geometry, state):
            raise SnapshotError("snapshot checksum mismatch (corrupt file?)")
        want = {"num_rows": self.num_rows, "dim": self.dim,
                "hot_size": self.hot_size, "cold_slots": self.cold_slots,
                "policy": self.config.policy}
        if geometry != want:
            raise SnapshotError(f"snapshot geometry {geometry} != cache {want}")
        slot_id = np.asarray(state["slot_id"], np.int64)
        slot_rrpv = np.asarray(state["slot_rrpv"], np.int64)
        slot_ts = np.asarray(state["slot_ts"], np.int64)
        if not (slot_id.shape == slot_rrpv.shape == slot_ts.shape
                == (self.cold_slots,)):
            raise SnapshotError("snapshot state arrays have the wrong shape")
        resident = slot_id >= 0
        ids = slot_id[resident]
        if ids.size and (ids.min() < self.hot_size
                         or ids.max() >= self.num_rows
                         or np.unique(ids).size != ids.size):
            raise SnapshotError("snapshot resident ids out of range/duplicated")
        self._slot_id = slot_id
        self._slot_rrpv = slot_rrpv
        self._slot_ts = slot_ts
        self._clock = int(state["clock"])
        self._id_slot = np.full(self.num_rows, -1, np.int64)
        self._id_slot[ids] = np.flatnonzero(resident)
        self._resident = int(ids.size)
        # warm fill: one batched gather from the backing table re-creates
        # the resident cold rows (row data is never part of the snapshot)
        if ids.size:
            self._cold_rows_host[np.flatnonzero(resident)] = self.table[ids]
            self._cold_rows_dirty = True
            self.cold_rows_device()   # eager: restore is once-per-restart
        self.metrics.count("snapshot_restores")
        self.metrics.gauge("restored_resident", int(ids.size))

    def save_snapshot(self, path: str) -> Dict:
        """``snapshot()`` to a JSON file (atomic rename — a crash mid-write
        leaves the previous snapshot intact, not a torn file)."""
        snap = self.snapshot()
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, path)
        return snap

    def load_snapshot(self, path: str) -> bool:
        """Restore from ``path`` if it exists and validates; returns True on
        a warm start, False on a (silent) cold start when the file is
        missing. Everything else — a torn/unparseable file included —
        raises ``SnapshotError``, and the caller decides whether a corrupt
        snapshot is fatal or just a cold start."""
        if not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                snap = json.load(f)
        except (OSError, ValueError) as e:   # JSONDecodeError is a ValueError
            raise SnapshotError(f"unreadable snapshot {path}: {e}") from e
        self.restore(snap)
        return True

    # ------------------------------------------------------------------
    def check_consistency(self) -> None:
        """Invariants the eviction tests lean on (cheap; host metadata only)."""
        res = self._slot_id >= 0
        assert int(res.sum()) <= self.cold_slots
        assert self._resident == int(res.sum()), "resident counter drifted"
        ids = self._slot_id[res]
        assert np.unique(ids).size == ids.size, "duplicate id in cold region"
        assert (self._id_slot[ids] == np.flatnonzero(res)).all()
        back = np.flatnonzero(self._id_slot >= 0)
        assert (self._slot_id[self._id_slot[back]] == back).all()
