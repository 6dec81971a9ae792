"""The least bytes of the rounds in the traced slice over the HBM peak,
as a share (%) of the slice's device busy time.  Rounds are counted from
the probe kernels the trace holds (one launch per join and hop)."""

from unionbench import roofline
from unionbench.profiling import family


def read(run):
    p, pb = run.profile, run.state.get("piece_batches")
    if not p or not pb or not p.get("busy_s"):
        return None
    launches = sum(c for n, (_, c) in p["by_name"].items()
                   if family(n) == "probe kernels")
    rounds = launches / roofline.probe_launches_per_round(run.union, pb)
    if rounds <= 0:
        return None
    least = rounds * roofline.round_bytes(run.union, pb) / roofline.HBM_BYTES_PER_S
    return 100.0 * least / p["busy_s"]
