"""ψ over the window: candidate draws per sample emitted
(``SamplerStats``)."""


def read(run):
    if "host_syncs" not in run.after:
        return None
    emitted = run.delta("samples_emitted")
    if emitted <= 0:
        return None
    return run.delta("candidate_draws") / emitted
