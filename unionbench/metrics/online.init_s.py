"""Seconds to construct ``OnlineUnionSampler`` (histogram init, backend
build and upload)."""


def read(run):
    return run.spans.seconds.get("online.init_s")
