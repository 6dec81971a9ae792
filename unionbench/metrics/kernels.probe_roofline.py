"""B1 ``sorted_probe`` and B2 ``probe_pick``: the least bytes of their
launches in the traced slice over the HBM peak, as a share (%) of their
device time by name in the trace."""

from unionbench import roofline
from unionbench.profiling import family


def read(run):
    p, pb = run.profile, run.state.get("piece_batches")
    if not p or not pb:
        return None
    hits = [v for n, v in p["by_name"].items() if family(n) == "probe kernels"]
    seconds = sum(s for s, _ in hits)
    launches = sum(c for _, c in hits)
    if seconds <= 0:
        return None
    rounds = launches / roofline.probe_launches_per_round(run.union, pb)
    least = rounds * roofline.probe_bytes(run.union, pb) / roofline.HBM_BYTES_PER_S
    return 100.0 * least / seconds
