"""Plain numpy references of the benchmark and the comparison that decides
``correct`` (:mod:`.judge`).

A configuration's ``reference`` names a module here; each exposes one
entry, ``reference(union, precision="f64")``, that returns an object with
the interface :class:`.judge.Reference` (and, for the control,
``sample(n, rng)`` and ``rows_of(ids)``, and ``precision="bf16"``).
:mod:`.chain_union` is the exact reference of a union of chains over one
chain (UQ1, UQ2).  None of them imports anything of the program, of the
JAX package or of JAX."""
