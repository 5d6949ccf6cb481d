"""Reserved token ids, identical to the JAX package's data pipeline (the
serving path needs EOS; the rest of the pipeline is ported with training)."""
from __future__ import annotations

VOCAB_RESERVED = 4          # pad=0, bos=1, eos=2, mask=3
PAD, BOS, EOS, MASK = range(VOCAB_RESERVED)
