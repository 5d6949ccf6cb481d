from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.grad_utils import (  # noqa: F401
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import make_schedule  # noqa: F401
