"""Wall milliseconds inside the membership oracle's ``contains`` per row
delivered in the window (Algorithm 2)."""


def read(run):
    if "contains_s" not in run.after:
        return None
    rows = sum(r.got for r in run.window.records if not r.failed)
    if rows <= 0:
        return None
    return 1e3 * run.delta("contains_s") / rows
