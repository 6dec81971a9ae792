"""Seconds the engine spent capturing its rounds as CUDA graphs, summed
over capacity classes (``capture_seconds``; all of it in set-up)."""


def read(run):
    v = run.after.get("capture_s")
    return None if v is None else float(v)
