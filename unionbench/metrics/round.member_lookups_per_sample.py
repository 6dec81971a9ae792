"""(Live candidate, earlier piece) pairs that the round's membership test
looked up per sample the engine emitted in the window
(``SamplerStats.member_lookups``).  None where the program does not count
them."""


def read(run):
    if "member_lookups" not in run.after:
        return None
    emitted = run.delta("samples_emitted")
    if emitted <= 0:
        return None
    return run.delta("member_lookups") / emitted
