"""Document packing and file-backed corpora (numpy only).

Copy of ``repro/data/packing.py`` over the port's own pipeline ids and byte
tokenizer, so the same documents give the JAX package's arrays byte for
byte. A packed batch feeds `models.model.loss_fn` unchanged: the loss reads
its ``loss_mask``.

Production LM pipelines pack variable-length documents into fixed-length
training rows (BOS/EOS delimited, no padding waste) and mask the loss across
document boundaries. `pack_documents` implements the standard greedy packer;
`FileCorpus` feeds real text through the ByteTokenizer from a directory of
.txt files.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Sequence

import numpy as np

from repro_torch.data.pipeline import BOS, EOS, PAD, ByteTokenizer


def pack_documents(
    docs: Sequence[np.ndarray],
    seq_len: int,
    *,
    mask_cross_document: bool = True,
) -> Dict[str, np.ndarray]:
    """Greedy-pack documents into (N, seq_len+1) rows of [BOS doc EOS ...].

    Returns causal-LM fields: tokens/labels shifted by one, loss_mask zeros
    on PAD and (optionally) on positions whose LABEL starts a new document
    (cross-document next-token prediction is noise).
    """
    rows: List[np.ndarray] = []
    seg_ids: List[np.ndarray] = []          # document id per position
    cur = np.full((seq_len + 1,), PAD, np.int32)
    cur_seg = np.zeros((seq_len + 1,), np.int32)
    pos = 0
    seg = 0

    def flush():
        nonlocal cur, cur_seg, pos
        if pos > 0:
            rows.append(cur)
            seg_ids.append(cur_seg)
            cur = np.full((seq_len + 1,), PAD, np.int32)
            cur_seg = np.zeros((seq_len + 1,), np.int32)
            pos = 0

    for doc in docs:
        seg += 1
        piece = np.concatenate([[BOS], doc.astype(np.int32), [EOS]])
        off = 0
        while off < len(piece):
            take = min(len(piece) - off, seq_len + 1 - pos)
            cur[pos:pos + take] = piece[off:off + take]
            cur_seg[pos:pos + take] = seg
            pos += take
            off += take
            if pos == seq_len + 1:
                flush()
    flush()

    if not rows:
        return {"tokens": np.zeros((0, seq_len), np.int32),
                "labels": np.zeros((0, seq_len), np.int32),
                "loss_mask": np.zeros((0, seq_len), np.int32)}
    toks = np.stack(rows)
    segs = np.stack(seg_ids)
    tokens = toks[:, :-1]
    labels = toks[:, 1:]
    mask = (labels != PAD).astype(np.int32)
    if mask_cross_document:
        # label must belong to the same document as its input position
        mask &= (segs[:, 1:] == segs[:, :-1]).astype(np.int32)
    return {"tokens": tokens, "labels": labels, "loss_mask": mask}


def packing_efficiency(batch: Dict[str, np.ndarray]) -> float:
    """Fraction of positions carrying real (non-PAD) tokens."""
    if batch["tokens"].size == 0:
        return 0.0
    return float((batch["tokens"] != PAD).mean())


class FileCorpus:
    """Reads .txt files from a directory, tokenizes (byte-level), packs.

    Deterministic given (seed, epoch); document order shuffles per epoch.
    """

    def __init__(self, directory: str, seq_len: int, seed: int = 0):
        self.tokenizer = ByteTokenizer()
        self.seq_len = seq_len
        self.seed = seed
        self.paths = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.endswith(".txt"))
        if not self.paths:
            raise FileNotFoundError(f"no .txt files in {directory}")

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    def _docs(self, epoch: int) -> List[np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        order = rng.permutation(len(self.paths))
        docs = []
        for i in order:
            with open(self.paths[i], "rb") as f:
                text = f.read().decode("utf-8", errors="replace")
            docs.append(self.tokenizer.encode(text))
        return docs

    def batches(self, batch_size: int, epoch: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        packed = pack_documents(self._docs(epoch), self.seq_len)
        n = packed["tokens"].shape[0]
        for i in range(0, n - batch_size + 1, batch_size):
            yield {k: v[i:i + batch_size] for k, v in packed.items()}
