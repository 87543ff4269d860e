"""The whole trial's share of the HBM roofline, in percent: the least bytes
the app's semantics need, at the HBM peak, over the device's busy time.

It is read over the checked trials, whose work the plain reference counts
iteration by iteration: the active vertices A_i and the edges out of them
F_i. The least an iteration can read is, for each of those edges, what the
app reads of it (``EDGE_BYTES``: 4 for the source id of PageRank-Delta, 8
for SSSP's target id and weight), and for each active vertex its two CSR
offsets (8 bytes); a trial also writes its N float32 answers once. So

    least bytes = sum_i (EDGE_BYTES * F_i + 8 * A_i) + 4 N.

This counts the work whatever kernels do it, so a fused gather and
reduction, or one that reads only the frontier's edges, keeps it. Reads of
per-vertex state are left out: a lower count, never a higher one.
"""
from gbench.peaks import HBM_BYTES_PER_S


def read(r):
    busy = sum(r.trace.trial_busy_s.get(k, 0.0) for k in r.checked)
    if not busy:
        return None
    least = sum(sum(r.edge_bytes * f + 8 * a for a, f in frontier) + 4 * r.num_nodes
                for frontier in r.checked.values())
    return 100.0 * least / HBM_BYTES_PER_S / busy
