"""Seconds from process start to the window's start: imports, CUDA init,
the kernel library's load, inputs, catalog, warm-up, cover, engine build,
graph capture of the mix's capacity classes and one warm request."""


def read(run):
    return run.setup_s
