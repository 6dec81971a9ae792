"""Samples delivered to clients by requests that completed inside the
window, over the window's seconds (a failed request delivers nothing)."""


def read(run):
    end = run.t_window + run.seconds
    got = sum(r.got for r in run.window.records
              if not r.failed and r.done <= end)
    return got / run.seconds
