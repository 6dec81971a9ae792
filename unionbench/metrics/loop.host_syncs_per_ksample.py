"""Host syncs of the engine's round loop per thousand samples it emitted
in the window (the engine's ``host_syncs`` counter)."""


def read(run):
    if "host_syncs" not in run.after:
        return None
    emitted = run.delta("samples_emitted")
    if emitted <= 0:
        return None
    return run.delta("host_syncs") / (emitted / 1e3)
