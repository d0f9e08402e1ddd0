"""Deterministic data pipeline: synthetic token stream + memmap corpus.

Own copy of ``repro.data.pipeline`` (numpy only): the same batches, byte for
byte.  A batch is numpy; the caller moves it to its device.

Multi-controller pattern: each host materializes only its own slice of
the global batch (``host_slice``), determined by (step, host_id), so a
restart at step k reproduces the exact global batch — the data half of
fault-tolerant resume.  The synthetic stream is a counter-seeded
Philox-style hash (pure numpy, no RNG state to checkpoint)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataCfg:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    corpus: Optional[str] = None        # path to a uint16/uint32 memmap
    num_hosts: int = 1
    host_id: int = 0


def _hash_tokens(step: int, rows: np.ndarray, seq: int, vocab: int,
                 seed: int) -> np.ndarray:
    """Counter-based token synthesis: tokens = h(step, row, col) % vocab."""
    col = np.arange(seq, dtype=np.uint64)[None, :]
    row = rows.astype(np.uint64)[:, None]
    x = (row * np.uint64(2654435761) ^ col * np.uint64(40503)
         ^ np.uint64(step * 997 + seed * 1_000_003 + 12345))
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    return (x % np.uint64(vocab)).astype(np.int32)


class TokenPipeline:
    def __init__(self, cfg: DataCfg):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global batch must divide across hosts")
        self.per_host = cfg.global_batch // cfg.num_hosts
        self._mm = None
        if cfg.corpus:
            self._mm = np.memmap(cfg.corpus, dtype=np.uint16, mode="r")

    def host_rows(self) -> np.ndarray:
        start = self.cfg.host_id * self.per_host
        return np.arange(start, start + self.per_host)

    def batch(self, step: int) -> dict:
        """Host-local slice of global batch ``step`` (deterministic)."""
        cfg = self.cfg
        rows = self.host_rows()
        if self._mm is None:
            tokens = _hash_tokens(step, rows, cfg.seq_len + 1, cfg.vocab,
                                  cfg.seed)
        else:
            n = len(self._mm) - (cfg.seq_len + 1)
            offs = (_hash_tokens(step, rows, 1, max(1, n), cfg.seed)[:, 0]
                    .astype(np.int64))
            tokens = np.stack([np.asarray(self._mm[o:o + cfg.seq_len + 1],
                                          dtype=np.int32) for o in offs])
            tokens %= cfg.vocab
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
