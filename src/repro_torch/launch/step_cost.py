"""What one step costs, counted while it runs: the port's counterpart of
``repro/launch/hlo_cost.py``.

JAX's dry run reads the compiled HLO, where a scanned layer stack is one
while loop whose body XLA's cost analysis counts once, so ``hlo_cost``
multiplies by trip counts. The port runs its steps eagerly: a dispatch
mode sees every aten op each time it executes (the backward included),
so a loop of L layers is counted L times by construction. ``measure``
runs a step under :class:`StepCounter` and returns:

* ``aten_flops``: ``FlopCounterMode``'s formulas over the aten ops, and
  ``kernel_flops``, the cost functions of the CUDA kernels the step
  launched (their wrappers report it from the fake path,
  ``kernels/common.add_cost``; a real launch is invisible to the
  dispatcher, as a ``pallas_call`` is not a dot to XLA);
* ``bytes_upper``: the bytes of the inputs and outputs of every op that
  reads or writes memory (views, ``empty`` and metadata queries move
  nothing), plus the kernels' cost bytes: each op a round trip to memory,
  no fusion;
* ``bytes_lower``: the step's arguments and outputs, each storage counted
  once: perfect fusion;
* ``peak_bytes``: the most bytes of live storage at any point, the
  arguments included, tracked through weak references to each storage
  the step allocates, and ``peak_storages``, how many storages were live
  then;
* the kernels' launches, and the collectives of ``parallel/comm.py`` by op
  and by mesh dim (bytes one rank receives, and calls), and their bytes by
  (op, mesh dim).

On FakeTensors nothing is computed or allocated: the counts are those of
the real step on tensors of the same shapes.
"""
from __future__ import annotations

import collections
import weakref
from typing import Any, Callable, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import common as kcommon
from repro_torch.parallel import comm

# ops that allocate without touching memory
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (x for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def storage_bytes(tree, device_type: str) -> int:
    """Bytes of the distinct storages of the tensors in `tree` on
    `device_type` (host tensors, such as the optimizer's step counter, are
    left out)."""
    seen: Dict[int, int] = {}
    for t in _tensors(tree):
        if t.device.type == device_type:
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class StepCounter(TorchDispatchMode):
    """Traffic and live storage of the ops run under it (see the module
    docstring); `track(tree)` marks tensors that live before the step."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.bytes_upper = 0
        self.live = 0
        self.peak = 0
        self.peak_storages = 0
        self._held: Dict[int, Any] = {}

    def _hold(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self.live += n
        self._held[key] = weakref.finalize(st, self._release, key, n)
        if self.live > self.peak:
            self.peak, self.peak_storages = self.live, len(self._held)

    def _release(self, key: int, n: int) -> None:
        self.live -= n
        self._held.pop(key, None)

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._hold(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = list(_tensors(out))
        # metadata queries (a fake tensor's device, sizes) return none
        if outs and not func.is_view and \
                func.overloadpacket.__name__ not in _NO_TRAFFIC:
            self.bytes_upper += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs, out)))
        for t in outs:
            self._hold(t)
        return out


def measure(step: Callable, args: tuple, *, device_type: str) -> Dict:
    """Run ``step(*args)`` under the counters; returns the counts of the
    module docstring and the step's output under "out"."""
    kernels: Dict[str, list] = collections.defaultdict(lambda: [0, 0, 0])

    def sink(name, flops, nbytes):
        k = kernels[name]
        k[0] += 1
        k[1] += flops
        k[2] += nbytes

    comm.reset_counters()
    arg_bytes = storage_bytes(args, device_type)
    counter = StepCounter(device_type)
    counter.track(args)
    with kcommon.cost_sink(sink), \
            FlopCounterMode(display=False) as flops, counter:
        out = step(*args)
    kernel_flops = sum(k[1] for k in kernels.values())
    kernel_bytes = sum(k[2] for k in kernels.values())
    return {
        "out": out,
        "argument_bytes": arg_bytes,
        "aten_flops": flops.get_total_flops(),
        "kernel_flops": kernel_flops,
        "flops": flops.get_total_flops() + kernel_flops,
        "bytes_upper": counter.bytes_upper + kernel_bytes,
        "bytes_lower": storage_bytes((args, out), device_type),
        "peak_bytes": counter.peak,
        "peak_storages": counter.peak_storages,
        "kernels": {name: {"launches": k[0], "flops": k[1], "bytes": k[2]}
                    for name, k in sorted(kernels.items())},
        "collectives": {op: {"bytes": comm.BYTES[op],
                             "calls": comm.CALLS[op]}
                        for op in sorted(comm.CALLS)},
        "collectives_by_dim": {d: {"bytes": comm.DIM_BYTES[d],
                                   "calls": comm.DIM_CALLS[d]}
                               for d in sorted(comm.DIM_CALLS)},
        "collective_bytes_by_op_dim": {
            f"{op}/{d}": n
            for (op, d), n in sorted(comm.OP_DIM_BYTES.items())},
    }
