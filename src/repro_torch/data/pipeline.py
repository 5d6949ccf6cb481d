"""Deterministic, checkpointable data pipeline (numpy only).

Copy of ``repro/data/pipeline.py``: the same reserved ids, byte tokenizer
and structured synthetic corpus (Zipfian unigrams, copy/recall spans,
arithmetic progressions), the causal-LM and the MLM batches, drawn from the
same numpy generators, so a seed gives the JAX package's batches byte for
byte. Every batch is a pure
function of (seed, step, shard); `DataState` {seed, step} is what a
checkpoint stores.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

VOCAB_RESERVED = 4          # pad=0, bos=1, eos=2, mask=3
PAD, BOS, EOS, MASK = range(VOCAB_RESERVED)


@dataclasses.dataclass
class DataState:
    seed: int = 0
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d) -> "DataState":
        return DataState(int(d["seed"]), int(d["step"]))


class ByteTokenizer:
    """Reversible byte-level tokenizer (offsets past the reserved ids)."""

    vocab_size = 256 + VOCAB_RESERVED

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32) \
            + VOCAB_RESERVED

    def decode(self, ids: np.ndarray) -> str:
        ids = np.asarray(ids)
        ids = ids[ids >= VOCAB_RESERVED] - VOCAB_RESERVED
        return bytes(ids.astype(np.uint8)).decode("utf-8", errors="replace")


class SyntheticCorpus:
    """Structured synthetic token streams over an arbitrary vocab."""

    def __init__(self, vocab_size: int, seed: int = 0):
        if vocab_size <= VOCAB_RESERVED + 8:
            raise ValueError(f"vocab_size={vocab_size} too small")
        self.vocab_size = vocab_size
        self.seed = seed
        # Zipfian unigram distribution over the non-reserved vocab
        ranks = np.arange(1, vocab_size - VOCAB_RESERVED + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))

    def sequence(self, rng: np.random.Generator, length: int) -> np.ndarray:
        """One document: zipf tokens + copy spans + progressions."""
        toks = rng.choice(len(self._p), size=length, p=self._p).astype(np.int32) \
            + VOCAB_RESERVED
        # copy/recall: repeat an earlier span later in the sequence
        n_copies = max(1, length // 128)
        for _ in range(n_copies):
            span = int(rng.integers(4, 17))
            if length < 3 * span:
                break
            src = int(rng.integers(0, length - 2 * span))
            dst = int(rng.integers(src + span, length - span))
            toks[dst:dst + span] = toks[src:src + span]
        # arithmetic progression (locally predictable structure)
        span = min(16, length // 4)
        if span >= 4:
            start = int(rng.integers(0, length - span))
            base = int(rng.integers(VOCAB_RESERVED, self.vocab_size - span - 1))
            toks[start:start + span] = base + np.arange(span)
        toks[0] = BOS
        return toks

    def batch(self, step: int, shard: int, batch: int, seq: int) -> np.ndarray:
        rng = self._rng(step, shard)
        return np.stack([self.sequence(rng, seq) for _ in range(batch)])


def make_causal_batch(corpus: SyntheticCorpus, state: DataState, *,
                      batch: int, seq: int, shard: int = 0
                      ) -> Dict[str, np.ndarray]:
    """Next-token-prediction batch: inputs t, labels t+1."""
    toks = corpus.batch(state.step, shard, batch, seq + 1)
    return {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
        "loss_mask": np.ones((batch, seq), np.int32),
    }


def make_mlm_batch(corpus: SyntheticCorpus, state: DataState, *,
                   batch: int, seq: int, mask_prob: float = 0.15,
                   shard: int = 0) -> Dict[str, np.ndarray]:
    """BERT-style masking: 80% [MASK] / 10% random / 10% keep. The masking
    draws come from their own stream (shard + 1_000_003); BOS is never
    masked; the loss mask marks the masked positions only."""
    rng = corpus._rng(state.step, shard + 1_000_003)
    toks = corpus.batch(state.step, shard, batch, seq)
    labels = toks.copy()
    is_masked = rng.random(toks.shape) < mask_prob
    is_masked[:, 0] = False                       # keep BOS
    roll = rng.random(toks.shape)
    inp = toks.copy()
    inp[is_masked & (roll < 0.8)] = MASK
    rnd = rng.integers(VOCAB_RESERVED, corpus.vocab_size, toks.shape)
    sel = is_masked & (roll >= 0.8) & (roll < 0.9)
    inp[sel] = rnd[sel]
    return {
        "tokens": inp,
        "labels": labels,
        "loss_mask": is_masked.astype(np.int32),
    }


def batches(corpus: SyntheticCorpus, state: DataState, *, batch: int,
            seq: int, objective: str = "causal_lm", mask_prob: float = 0.15,
            shard: int = 0
            ) -> Iterator[Tuple[Dict[str, np.ndarray], DataState]]:
    """Infinite deterministic batch stream; yields (batch, next_state).
    ``objective="mlm"`` gives masked-LM batches, anything else causal-LM
    ones (as in the JAX package)."""
    step = state.step
    while True:
        st = DataState(state.seed, step)
        if objective == "mlm":
            b = make_mlm_batch(corpus, st, batch=batch, seq=seq,
                               mask_prob=mask_prob, shard=shard)
        else:
            b = make_causal_batch(corpus, st, batch=batch, seq=seq,
                                  shard=shard)
        step += 1
        yield b, DataState(state.seed, step)
