"""Millions of rows that the program's host join expansions built, summed
over joins (the registry counter ``repro_warmup_rows_materialised_total``):
the exact warm-up's materialisations, all of them in set-up.  None where
the program has no such counter."""

COUNTER = "repro_warmup_rows_materialised_total"


def read(run):
    from repro_torch.obs.metrics import get_registry
    counter = get_registry().get(COUNTER)
    if counter is None:
        return None
    return sum(counter.snapshot().values()) / 1e6
