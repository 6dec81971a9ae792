"""The LM side of the port: configs' ``ModelConfig``, layers, the forward
pass for inference, KV caches and one-token decode (``dense`` and
``gemma2``; the other families raise ``NotImplementedError``)."""
