"""Share of the window's candidate draws that the §8.2 residual test
rejected, in per cent: skeleton walks whose residual probe found no row
(``SamplerStats.residual_misses``, d = 0) and those that lost the ``Π d/M``
draw (``residual_rejects``), over ``candidate_draws``.  None where the
program does not count residual misses."""


def read(run):
    if "residual_misses" not in run.after:
        return None
    draws = run.delta("candidate_draws")
    if draws <= 0:
        return None
    return 100.0 * (run.delta("residual_misses")
                    + run.delta("residual_rejects")) / draws
