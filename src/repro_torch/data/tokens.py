"""Token pipeline for LM training: synthetic deterministic streams plus a
memmap .bin reader, with host-side sharding for multi-process data
parallelism (each host loads only its DP shard)."""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


def synthetic_tokens(vocab_size: int, batch: int, seq_len: int, step: int,
                     seed: int = 0) -> dict:
    """Deterministic pseudo-corpus: a mixture of Zipfian unigrams and
    shifted-repeat structure so models have learnable signal."""
    rng = np.random.default_rng(np.uint32(seed) + np.uint32(step))
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab_size, size=(batch, seq_len + 1), p=probs)
    # inject copy structure: second half repeats first half with shift
    half = seq_len // 2
    toks[:, half:half * 2] = (toks[:, :half] + 1) % vocab_size
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


@dataclasses.dataclass
class TokenPipeline:
    """Iterable pipeline. If `bin_path` exists, reads a flat int32 memmap
    corpus; otherwise generates synthetic batches. `dp_rank`/`dp_size`
    shard the global batch across hosts."""
    vocab_size: int
    batch: int                 # GLOBAL batch
    seq_len: int
    bin_path: Optional[str] = None
    dp_rank: int = 0
    dp_size: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.batch % self.dp_size:
            raise ValueError("global batch must divide by dp_size")
        self._local_batch = self.batch // self.dp_size
        self._mm = None
        if self.bin_path and Path(self.bin_path).exists():
            self._mm = np.memmap(self.bin_path, dtype=np.int32, mode="r")

    def get_batch(self, step: int) -> dict:
        """The (tokens, labels) dict for one train step — deterministic
        per step, memory-mapped when a corpus file is configured."""
        if self._mm is None:
            full = synthetic_tokens(self.vocab_size, self.batch, self.seq_len,
                                    step, self.seed)
        else:
            n_tok = self.batch * (self.seq_len + 1)
            start = (step * n_tok) % max(1, (len(self._mm) - n_tok))
            flat = np.asarray(self._mm[start:start + n_tok])
            toks = flat.reshape(self.batch, self.seq_len + 1) % self.vocab_size
            full = {"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)}
        lo = self.dp_rank * self._local_batch
        hi = lo + self._local_batch
        return {k: v[lo:hi] for k, v in full.items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.get_batch(step)
            step += 1
