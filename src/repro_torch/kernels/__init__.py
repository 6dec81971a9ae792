"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every kernel of ``csrc/`` is built into one library by :mod:`.build` and
shares its launch counter (``build.launch_counts``):

* ``probe.sorted_probe`` — sorted-key range probe
  (replaces ``repro/kernels/searchsorted.py`` fence_count + refine);
* ``probe.probe_pick`` — probe and ranged uniform pick
  (replaces ``repro/kernels/walk.py`` hop_refine_pick);
* ``segdegree.segdegree`` — distinct count and max degree of a sorted
  column (replaces ``repro/kernels/segdegree.py``);
* ``attention.decode_attention`` — one-token GQA decode attention
  (replaces ``repro/kernels/attention.py``);
* ``member.member_lookup`` — the union round's earlier-piece membership
  test, fingerprints and sorted lookups fused (no Pallas counterpart: the
  reference runs it as XLA ops).

:mod:`.ops` is the entry point with the reference's names and contracts
(``repro.kernels.ops``).
"""
