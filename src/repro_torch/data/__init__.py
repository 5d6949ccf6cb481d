from repro_torch.data.pipeline import (  # noqa: F401
    BOS, EOS, MASK, PAD, DataState, SyntheticCorpus, batches,
    make_causal_batch)
