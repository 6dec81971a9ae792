"""PyTorch/CUDA port of the union-of-joins sampling system.

A second package beside the JAX reference ``repro``: it imports ``torch``
and ``numpy`` only (never ``jax``, never ``repro``), keeps its own copies of
the numpy host layer, and runs the Algorithm-1 set-union engine on an NVIDIA
Hopper card, with every sorted-key range probe of a draw going through the
hand-written CUDA kernels of :mod:`repro_torch.kernels.probe`.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
without a card they raise instead of carrying on on the CPU.
"""
