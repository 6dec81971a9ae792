"""Host layer (numpy copies of ``repro.core``) and the torch union engine."""
