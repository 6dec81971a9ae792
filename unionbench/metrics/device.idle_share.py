"""Share (%) of the traced slice in which no operation ran on the card:
1 - the union of device intervals over the slice's length."""


def read(run):
    p = run.profile
    if not p or not p.get("window_s") or not p.get("device_events"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
