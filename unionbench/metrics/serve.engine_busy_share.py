"""Share of the window (%) that the service's producer spends inside the
engine (``sample``, ``sample_async`` and the handle's ``result``), timed by
the benchmark's proxy engine."""


def read(run):
    if "engine_busy_s" not in run.after:
        return None
    return 100.0 * run.delta("engine_busy_s") / run.delta("engine_clock_s")
