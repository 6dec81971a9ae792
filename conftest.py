"""Sizes at which the benchmark's CPU tests run each union: the harness's
test support keeps those of the chains (UQ1, UQ2); the Q5 cyclic union's is
registered here, for every test that copies the benchmark's files."""

from unionbench.tests import support

# a draw closes Q5's cycle about once in 25, so the engine's calls are kept
# small on the CPU
support.SCALES.setdefault("q5", {"sf": 0.005, "overlap": 0.4,
                                 "round_batch": 2048,
                                 "service": {"batch": 1024, "prefetch": 2}})
