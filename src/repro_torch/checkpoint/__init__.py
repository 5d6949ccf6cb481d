from repro_torch.checkpoint.bridge import (  # noqa: F401
    params_from_flat, read_params_npz)
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
