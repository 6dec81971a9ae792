"""The LM side of the port: configs' ``ModelConfig``, layers, the forward
pass of every family, KV and SSM caches, one-token decode and prefill, and
the training loss (``dense`` and ``gemma2``; the other families' training
raises ``NotImplementedError``)."""
