"""Plain numpy reference of the benchmark: exact sizes, marginals and
membership of a union of chain joins (:mod:`.chain_union`) and the
comparison that decides ``correct`` (:mod:`.judge`).  It imports nothing
of the program, of the JAX package or of JAX."""
