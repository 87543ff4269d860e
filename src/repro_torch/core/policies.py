"""LLC replacement policies (paper Secs. III-C, IV-C), as host-side steps.

Each policy is a pair of functions driven by ``cachesim.simulate``'s
per-record loop:

    init(cfg)                                       -> state (mutated in place)
    step(cfg, state, line, hint, pc, region, nxt, t) -> hit: bool

``line`` is the cache-line id, ``hint`` the GRASP 2-bit Reuse Hint, ``pc``
the synthetic PC signature, ``region`` the 16KB memory-region id, ``nxt``
the time of the next access to this line (INF if none) and ``t`` the
current time. State is Python lists of ints: one list of ``ways`` entries
per set.

The records must be replayed strictly in order: the DRRIP set-dueling
counters ``psel`` and ``brrip_cnt`` are global across sets, so no record can
be split off by set. The simulator therefore runs on the host and never on
the card.

Bit-exactness with the JAX package rests on details kept here:
``argmax``/``argmin`` pick the first way on ties (``list.index``); RRPVs
follow int8 arithmetic, which never wraps because every RRPV stays in
[0, RRPV_MAX]; lines arrive cast to int32 with ``nxt`` clipped to INF; and
the JAX package's vectorised step computes the aged row and the victim on
every access but keeps them only on a miss, so a hit here writes into the
row as it was (``_rrip_victim`` ages in place and runs on misses only).

Schemes (the JAX package's thirteen):
  lru           true LRU (baseline of paper Table VII / Fig. 11)
  rrip          DRRIP with set dueling (paper's high-performance baseline)
  rrip_hints    Fig. 7 ablation: RRIP + software hints steer the two RRIP
                insertion positions
  grasp_insert  Fig. 7 ablation: GRASP insertion policy only
  grasp         full GRASP per Table II (insertion + hit-promotion)
  ship_mem      SHiP-MEM [49]: region-signature hit predictor over RRIP
  hawkeye       Hawkeye-lite [26]: PC-classifier trained with *exact*
                Belady labels (favourable to Hawkeye; our reproduction of
                its failure mode is therefore conservative)
  leeway        Leeway-lite [10]: PC-indexed live-distance dead-block
                prediction over the base victim policy
  pin_X         XMem-style pinning, X% of ways reservable (X=25,50,75,100)
  opt           Belady's MIN with bypass (offline upper bound)

All RRIP-family policies use a 3-bit RRPV (paper Table II: insert values
0/6/7, max 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

RRPV_MAX = 7          # 3-bit counter
RRPV_LONG = 6         # "near LRU" insertion (SRRIP long re-reference)
INF = 2**31 - 1       # int32 max: "no next use"
CTR_MAX = 7           # 3-bit saturating counters (SHiP's SHCT, Hawkeye's PC table)


@dataclasses.dataclass(frozen=True)
class CacheCfg:
    num_sets: int          # power of two
    ways: int
    n_pcs: int = 8
    n_regions: int = 4096
    duel_mod: int = 8      # leader-set stride for DRRIP set dueling
    psel_bits: int = 10
    brrip_throttle: int = 32   # 1/32 of BRRIP inserts use RRPV_LONG
    hawkeye_horizon_factor: int = 2  # Belady-label horizon = f*S*W

    @property
    def set_mask(self) -> int:
        return self.num_sets - 1

    @property
    def set_shift(self) -> int:
        return self.num_sets.bit_length() - 1

    @property
    def capacity_lines(self) -> int:
        return self.num_sets * self.ways


def _table(cfg: CacheCfg, value: int) -> list[list[int]]:
    return [[value] * cfg.ways for _ in range(cfg.num_sets)]


def _lookup(cfg: CacheCfg, tags, line: int):
    """(set, tag, way of the hit or -1)."""
    s = line & cfg.set_mask
    tag = line >> cfg.set_shift
    row = tags[s]
    return s, tag, (row.index(tag) if tag in row else -1)


def _rrip_victim(row: list[int]) -> int:
    """SRRIP victim: age all ways (in place) to put >=1 at RRPV_MAX, pick first."""
    delta = RRPV_MAX - max(row)
    if delta > 0:
        row[:] = [r + delta for r in row]
    return row.index(RRPV_MAX)


# --------------------------------------------------------------------------
# LRU
# --------------------------------------------------------------------------
def lru_init(cfg: CacheCfg):
    return dict(tags=_table(cfg, -1), ts=_table(cfg, -1))


def lru_step(cfg: CacheCfg, state, line, hint, pc, region, nxt, t) -> bool:
    s, tag, hway = _lookup(cfg, state["tags"], line)
    ts = state["ts"][s]
    way = hway if hway >= 0 else ts.index(min(ts))
    state["tags"][s][way] = tag
    ts[way] = t
    return hway >= 0


# --------------------------------------------------------------------------
# DRRIP base + the GRASP family (shared machinery, Table II semantics)
# --------------------------------------------------------------------------
def _drrip_init(cfg: CacheCfg):
    return dict(
        tags=_table(cfg, -1),
        rrpv=_table(cfg, RRPV_MAX),
        psel=1 << (cfg.psel_bits - 1),
        brrip_cnt=0,
    )


def _drrip_insert_rrpv(cfg: CacheCfg, state, s: int):
    """DRRIP default insertion value for set ``s`` (paper Table II Default)."""
    sr_leader = (s % cfg.duel_mod) == 0
    br_leader = (s % cfg.duel_mod) == 1
    if sr_leader:
        use_brrip = False
    elif br_leader:
        use_brrip = True
    else:
        use_brrip = state["psel"] >= (1 << (cfg.psel_bits - 1))
    brrip_val = RRPV_LONG if state["brrip_cnt"] % cfg.brrip_throttle == 0 else RRPV_MAX
    return (brrip_val if use_brrip else RRPV_LONG), sr_leader, br_leader


def _drrip_miss(cfg: CacheCfg, state, sr_leader: bool, br_leader: bool) -> None:
    """The set duel's counters after a miss: ``psel`` and ``brrip_cnt``."""
    state["psel"] = min(max(state["psel"] + sr_leader - br_leader, 0),
                        (1 << cfg.psel_bits) - 1)
    state["brrip_cnt"] += 1


def _drrip_family_step(cfg: CacheCfg, state, line, hint, insert_fn, hit_fn) -> bool:
    """Shared DRRIP skeleton. ``insert_fn(default_ins, hint)->rrpv`` and
    ``hit_fn(old_rrpv, hint)->rrpv`` specialize the policy (Table II)."""
    s, tag, hway = _lookup(cfg, state["tags"], line)
    row = state["rrpv"][s]
    if hway >= 0:
        row[hway] = hit_fn(row[hway], hint)
        return True

    default_ins, sr_leader, br_leader = _drrip_insert_rrpv(cfg, state, s)
    victim = _rrip_victim(row)
    row[victim] = insert_fn(default_ins, hint)
    state["tags"][s][victim] = tag
    _drrip_miss(cfg, state, sr_leader, br_leader)
    return False


def _mru(r, h):
    return 0  # hit promotion to MRU


def rrip_step(cfg, state, line, hint, pc, region, nxt, t) -> bool:
    return _drrip_family_step(cfg, state, line, hint,
                              insert_fn=lambda d, h: d,  # hints ignored
                              hit_fn=_mru)


def _rrip_hints_insert(d, h):
    # Fig. 7 "RRIP+Hints": High-Reuse inserted near LRU (RRPV_LONG), all
    # other blocks at LRU (RRPV_MAX); hits unchanged from RRIP.
    if h == 3:
        return d
    return RRPV_LONG if h == 0 else RRPV_MAX


def rrip_hints_step(cfg, state, line, hint, pc, region, nxt, t) -> bool:
    return _drrip_family_step(cfg, state, line, hint,
                              insert_fn=_rrip_hints_insert, hit_fn=_mru)


def _grasp_insert(default_ins, hint):
    # Table II insertion: High->0, Moderate->6, Low->7, Default->DRRIP.
    if hint == 0:
        return 0
    if hint == 1:
        return RRPV_LONG
    if hint == 2:
        return RRPV_MAX
    return default_ins


def grasp_insert_step(cfg, state, line, hint, pc, region, nxt, t) -> bool:
    # Fig. 7 "GRASP (Insertion-Only)": GRASP insertion + RRIP hit policy.
    return _drrip_family_step(cfg, state, line, hint,
                              insert_fn=_grasp_insert, hit_fn=_mru)


def _grasp_hit(r, h):
    # Full GRASP, Table II: High hit -> MRU; Moderate/Low hit -> gradual
    # promotion (decrement); Default hit -> MRU (base RRIP behaviour).
    return max(r - 1, 0) if h == 1 or h == 2 else 0


def grasp_step(cfg, state, line, hint, pc, region, nxt, t) -> bool:
    return _drrip_family_step(cfg, state, line, hint,
                              insert_fn=_grasp_insert, hit_fn=_grasp_hit)


# --------------------------------------------------------------------------
# SHiP-MEM: region-signature hit predictor (unlimited-entry table, paper IV-C)
# --------------------------------------------------------------------------
def ship_init(cfg: CacheCfg):
    st = _drrip_init(cfg)
    st.update(
        shct=[1] * cfg.n_regions,   # 3-bit, weakly reused
        sig=_table(cfg, 0),
        outcome=_table(cfg, False),
    )
    return st


def ship_step(cfg: CacheCfg, state, line, hint, pc, region, nxt, t) -> bool:
    # training: a hit strengthens the signature of *this* region; evicting a
    # never-reused block weakens the victim's. The set duel never moves.
    s, tag, hway = _lookup(cfg, state["tags"], line)
    shct = state["shct"]
    if hway >= 0:
        shct[region] = min(shct[region] + 1, CTR_MAX)
        state["rrpv"][s][hway] = 0
        state["outcome"][s][hway] = True
        return True
    victim = _rrip_victim(state["rrpv"][s])
    tags, sig, outcome = state["tags"][s], state["sig"][s], state["outcome"][s]
    if not outcome[victim] and tags[victim] >= 0:
        shct[sig[victim]] = max(shct[sig[victim]] - 1, 0)
    # original SHiP insertion semantics, read after the training above:
    # predicted-dead regions insert at distant RRPV, everything else at the
    # SRRIP long position (SHiP never inserts at MRU — its win comes from
    # filtering, not protection)
    state["rrpv"][s][victim] = RRPV_MAX if shct[region] == 0 else RRPV_LONG
    tags[victim], sig[victim], outcome[victim] = tag, region, False
    return False


# --------------------------------------------------------------------------
# Hawkeye-lite: PC classifier trained by Belady labels
# --------------------------------------------------------------------------
def hawkeye_init(cfg: CacheCfg):
    return dict(
        tags=_table(cfg, -1),
        rrpv=_table(cfg, RRPV_MAX),
        pctr=[4] * cfg.n_pcs,   # 3-bit, weakly friendly
    )


def hawkeye_step(cfg: CacheCfg, state, line, hint, pc, region, nxt, t) -> bool:
    s, tag, hway = _lookup(cfg, state["tags"], line)
    pctr = state["pctr"]
    # the prediction reads the counter before this access trains it with
    # the Belady label: would OPT have hit this line's next use?
    friendly = pctr[pc] >= 4
    horizon = cfg.hawkeye_horizon_factor * cfg.capacity_lines
    pctr[pc] = min(max(pctr[pc] + (1 if nxt - t <= horizon else -1), 0), CTR_MAX)
    # Hawkeye pathology reproduced (paper Sec. V-A): a hit whose PC is
    # predicted cache-averse is *demoted* (eviction priority), not promoted.
    value = 0 if friendly else RRPV_MAX
    row = state["rrpv"][s]
    if hway >= 0:
        row[hway] = value
        return True
    victim = _rrip_victim(row)
    row[victim] = value
    state["tags"][s][victim] = tag
    return False


# --------------------------------------------------------------------------
# Leeway-lite: PC-indexed live-distance dead-block prediction
# --------------------------------------------------------------------------
def leeway_init(cfg: CacheCfg):
    st = _drrip_init(cfg)  # Leeway rides the same DRRIP base as the baseline
    st.update(
        sig=_table(cfg, 0),
        birth=_table(cfg, 0),
        last_hit=_table(cfg, 0),
        acc=[0] * cfg.num_sets,   # per-set access clock
        ld=[0] * cfg.n_pcs,       # live distance per PC
    )
    return st


def leeway_step(cfg: CacheCfg, state, line, hint, pc, region, nxt, t) -> bool:
    s, tag, hway = _lookup(cfg, state["tags"], line)
    clock = state["acc"][s]
    state["acc"][s] = clock + 1
    last_hit = state["last_hit"][s]
    if hway >= 0:
        state["rrpv"][s][hway] = 0
        last_hit[hway] = clock
        return True

    tags, sig, birth, ld = state["tags"][s], state["sig"][s], state["birth"][s], state["ld"]
    # dead-block test: set-accesses since last hit exceed the PC's live
    # distance with a conservative margin (Leeway's variability-aware
    # policies keep it close to the base scheme when reuse is noisy —
    # paper Sec. V-A: max slowdown 2.1%). Predicted-dead blocks are demoted
    # to distant-re-reference and compete with natural RRPV_MAX candidates.
    row = state["rrpv"][s]
    for w in range(cfg.ways):
        live = ld[sig[w]]
        if live > 0 and clock - last_hit[w] > 2 * live + cfg.ways and tags[w] >= 0:
            row[w] = RRPV_MAX
    victim = _rrip_victim(row)

    # LD training on eviction: observed live distance of the victim block.
    # Grow to the observed max at once; shrink only on small deviations — a
    # large downward deviation signals high reuse variance, so keep the old LD.
    obs = last_hit[victim] - birth[victim]
    old = ld[sig[victim]]
    if obs > old:
        ld[sig[victim]] = obs
    elif obs * 2 >= old:
        ld[sig[victim]] = old - (old - obs) // 16

    default_ins, sr_leader, br_leader = _drrip_insert_rrpv(cfg, state, s)
    row[victim] = default_ins
    tags[victim], sig[victim], birth[victim], last_hit[victim] = tag, pc, clock, clock
    _drrip_miss(cfg, state, sr_leader, br_leader)
    return False


# --------------------------------------------------------------------------
# XMem-style pinning (PIN-X), driven by the GRASP High-Reuse classification
# --------------------------------------------------------------------------
def _pin_init(cfg: CacheCfg):
    st = _drrip_init(cfg)
    st["pinned"] = _table(cfg, False)
    return st


def _pin_step(cfg: CacheCfg, state, line, hint, quota_ways: int) -> bool:
    s, tag, hway = _lookup(cfg, state["tags"], line)
    row = state["rrpv"][s]
    if hway >= 0:
        row[hway] = 0  # pin status persists across hits
        return True
    pinned = state["pinned"][s]
    default_ins, sr_leader, br_leader = _drrip_insert_rrpv(cfg, state, s)
    _drrip_miss(cfg, state, sr_leader, br_leader)
    # victim among unpinned ways only (pinned blocks are neither aged nor
    # evicted); a fully pinned set cannot insert: the miss bypasses it
    free = [w for w in range(cfg.ways) if not pinned[w]]
    if not free:
        return False
    delta = RRPV_MAX - max(row[w] for w in free)
    if delta > 0:
        for w in free:
            row[w] += delta
    victim = next(w for w in free if row[w] == RRPV_MAX)
    want_pin = hint == 0 and sum(pinned) < quota_ways
    row[victim] = 0 if want_pin else default_ins
    state["tags"][s][victim] = tag
    pinned[victim] = want_pin
    return False


def _pin_policy(percent: int):
    def step(cfg, state, line, hint, pc, region, nxt, t) -> bool:
        # Python's round, as the JAX package: 2 ways at 25% pin 1
        quota = max(1, round(cfg.ways * percent / 100))
        return _pin_step(cfg, state, line, hint, quota)
    return _pin_init, step


# --------------------------------------------------------------------------
# Belady OPT with bypass
# --------------------------------------------------------------------------
def opt_init(cfg: CacheCfg):
    return dict(tags=_table(cfg, -1), nxt=_table(cfg, INF))


def opt_step(cfg: CacheCfg, state, line, hint, pc, region, nxt, t) -> bool:
    s, tag, hway = _lookup(cfg, state["tags"], line)
    nrow = state["nxt"][s]
    if hway >= 0:
        nrow[hway] = nxt
        return True
    furthest = max(nrow)
    if nxt >= furthest:  # bypass: this line is reused no sooner than any resident
        return False
    victim = nrow.index(furthest)
    state["tags"][s][victim] = tag
    nrow[victim] = nxt
    return False


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
POLICIES: Dict[str, Tuple[Callable, Callable]] = {
    "lru": (lru_init, lru_step),
    "rrip": (_drrip_init, rrip_step),
    "rrip_hints": (_drrip_init, rrip_hints_step),
    "grasp_insert": (_drrip_init, grasp_insert_step),
    "grasp": (_drrip_init, grasp_step),
    "ship_mem": (ship_init, ship_step),
    "hawkeye": (hawkeye_init, hawkeye_step),
    "leeway": (leeway_init, leeway_step),
    "opt": (opt_init, opt_step),
    **{f"pin_{x}": _pin_policy(x) for x in (25, 50, 75, 100)},
}


def get_policy(name: str) -> Tuple[Callable, Callable]:
    """(init, step) of a policy; ``KeyError`` naming any unknown one."""
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r} (known: {', '.join(POLICIES)})")
    return POLICIES[name]
