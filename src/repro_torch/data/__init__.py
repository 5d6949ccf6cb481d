from repro_torch.data.pipeline import (  # noqa: F401
    BOS, EOS, MASK, PAD, ByteTokenizer, DataState, SyntheticCorpus, batches,
    make_causal_batch, make_mlm_batch)
from repro_torch.data.packing import (  # noqa: F401
    FileCorpus, pack_documents, packing_efficiency)
