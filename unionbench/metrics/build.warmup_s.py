"""Seconds in ``warmup`` and ``estimate_union`` (the cover)."""


def read(run):
    return run.spans.seconds.get("build.warmup_s")
