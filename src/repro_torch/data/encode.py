"""Tuple → token encoding: the bridge from union samples to LM training.

The port's copy of the reference's ``repro/data/encode.py``, on the port's
:func:`repro_torch.core.relation.mix64`; it runs on the host in numpy and
its tokens equal the reference's exactly.  The union sampler emits i.i.d.
relational tuples; the trainer consumes fixed-shape token batches.
Encoding is feature-hashed:

    token(attr_i = v) = N_SPECIAL + i * buckets + (mix64(v) % buckets)

Tuples are packed into sequences separated by ``SEP`` until ``seq_len`` is
filled (document-packing style), so every position carries signal and batch
shapes are static.  Because the sample stream is i.i.d. uniform over the
union (the paper's guarantee), any contiguous packing preserves the
training distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core.relation import mix64

PAD, BOS, EOS, SEP = 0, 1, 2, 3
N_SPECIAL = 4


@dataclasses.dataclass
class TokenEncoder:
    attrs: List[str]
    vocab_size: int

    def __post_init__(self) -> None:
        usable = self.vocab_size - N_SPECIAL
        if usable < len(self.attrs):
            raise ValueError("vocab too small for attribute bucketing")
        self.buckets = usable // len(self.attrs)

    @property
    def tokens_per_tuple(self) -> int:
        return len(self.attrs) + 1  # + SEP

    def encode_rows(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        """(n, tokens_per_tuple) int32 token matrix (SEP-terminated tuples)."""
        n = next(iter(rows.values())).shape[0]
        out = np.empty((n, self.tokens_per_tuple), dtype=np.int32)
        for i, a in enumerate(self.attrs):
            h = mix64(np.asarray(rows[a]), salt=11 + i) % np.uint64(self.buckets)
            out[:, i] = (N_SPECIAL + i * self.buckets + h.astype(np.int64)).astype(np.int32)
        out[:, -1] = SEP
        return out

    def pack(self, rows: Dict[str, np.ndarray], batch: int, seq_len: int
             ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Pack tuples into (batch, seq_len) tokens + next-token targets.

        Returns (tokens, targets, tuples_consumed).  targets use PAD(=0) as
        the ignore label at sequence tails.
        """
        toks = self.encode_rows(rows)                       # (n, k)
        k = self.tokens_per_tuple
        per_seq = max((seq_len - 1) // k, 1)                # leave room for BOS
        need = per_seq * batch
        n = toks.shape[0]
        if n < need:
            raise ValueError(f"need {need} tuples, got {n}")
        body = toks[:need].reshape(batch, per_seq * k)
        tokens = np.full((batch, seq_len), PAD, dtype=np.int32)
        tokens[:, 0] = BOS
        tokens[:, 1:1 + per_seq * k] = body
        targets = np.full((batch, seq_len), PAD, dtype=np.int32)
        targets[:, :-1] = tokens[:, 1:]
        return tokens, targets, need
