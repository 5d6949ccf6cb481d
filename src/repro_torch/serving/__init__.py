from repro_torch.serving.engine import ServingEngine  # noqa: F401
from repro_torch.serving.faults import Fault, FaultInjector  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    Request, ScheduleStats, Scheduler, ShedResult, SlotPool)
from repro_torch.serving.snapshot import SlotSnapshot  # noqa: F401
