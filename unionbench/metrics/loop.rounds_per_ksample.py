"""Rounds the engine ran per thousand samples it emitted in the window
(the engine's ``total_rounds``)."""


def read(run):
    if "total_rounds" not in run.after:
        return None
    emitted = run.delta("samples_emitted")
    if emitted <= 0:
        return None
    return run.delta("total_rounds") / (emitted / 1e3)
