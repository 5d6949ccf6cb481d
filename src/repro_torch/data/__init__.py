from repro_torch.data.pipeline import BOS, EOS, MASK, PAD  # noqa: F401
