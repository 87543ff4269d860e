"""The retained pre-vectorization ``EmbeddingCache.lookup`` — the oracle.

``ReferenceEmbeddingCache`` keeps the original per-miss Python eviction
loop and the original assembly path (a full device->host copy of the cold
block — and, on the no-kernel path, of the hot block — per batched
lookup). The randomized equivalence tests replay identical id streams
through this class and the vectorized ``EmbeddingCache`` and require
bit-identical outputs, counters, and cold-region metadata — speed must
never buy different answers.

Semantics are frozen: do not "improve" this file — its slowness is the
baseline.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.serve.cache import EmbeddingCache, LookupStats


class ReferenceEmbeddingCache(EmbeddingCache):
    """``EmbeddingCache`` with the original sequential lookup loop."""

    def lookup(self, ids) -> Tuple[torch.Tensor, LookupStats]:
        ids = np.asarray(ids, np.int64).reshape(-1)
        b = ids.shape[0]
        if b == 0:
            # aligned with the vectorized short-circuit: no clock tick
            return self._finish(torch.zeros((0, self.dim), dtype=torch.float32,
                                            device=self.device), LookupStats())
        if ids.min() < 0 or ids.max() >= self.num_rows:
            raise IndexError("id out of range")
        self._clock += 1
        hot_mask = ids < self.hot_size
        hot_hits = int(hot_mask.sum())

        cold_ids = ids[~hot_mask]
        uniq = np.unique(cold_ids)
        fill_ids, fill_slots = [], []
        if uniq.size:
            resident = self._id_slot[uniq] >= 0
            hit_slots = self._id_slot[uniq[resident]]
            if hit_slots.size:
                self._promote(hit_slots)
            for rid in uniq[~resident]:
                if self.cold_slots == 0:
                    continue
                v = self._evict_one()
                old = self._slot_id[v]
                if old >= 0:
                    self._id_slot[old] = -1
                self._slot_id[v] = rid
                self._id_slot[rid] = v
                self._slot_rrpv[v] = self._insert_rrpv(int(rid))
                self._slot_ts[v] = self._clock
                fill_ids.append(rid)
                fill_slots.append(v)
        if fill_ids:
            # one row per slot, the slot's last fill in this batch
            for v, rid in dict(zip(fill_slots, fill_ids)).items():
                self._cold_rows[v] = torch.from_numpy(self.table[rid]).to(self.device)

        # --- assemble the batch (original: device round-trips) ---------
        out = np.zeros((b, self.dim), np.float32)
        if self.hot_size > 0 and hot_hits:
            if self.config.use_kernel:
                out[hot_mask] = self._gather_hot(ids, hot_mask).cpu().numpy()[hot_mask]
            else:
                # original no-kernel path: the whole hot block off-device
                out[hot_mask] = self._hot_block.cpu().numpy()[ids[hot_mask]]
        cold_mask = ~hot_mask
        slots = np.where(cold_mask, self._id_slot[ids], -1)
        served = cold_mask & (slots >= 0)
        if served.any():
            out[served] = self._cold_rows.cpu().numpy()[slots[served]]
        byp = cold_mask & (slots < 0)
        if byp.any():
            out[byp] = self.table[ids[byp]]

        byp_refs = int(byp.sum())
        misses = len(fill_ids) + byp_refs
        cold_hits = int(cold_mask.sum()) - misses
        stats = LookupStats(hot_hits=hot_hits, cold_hits=cold_hits,
                            misses=misses, bypassed=byp_refs)
        # keep the inherited invariants (incremental counter, host mirror)
        # coherent the way the original full-scan gauge did
        self._resident = int((self._slot_id >= 0).sum())
        if fill_slots:
            self._cold_rows_host[np.asarray(fill_slots)] = \
                self.table[np.asarray(fill_ids)]
        return self._finish(torch.from_numpy(out).to(self.device), stats)
