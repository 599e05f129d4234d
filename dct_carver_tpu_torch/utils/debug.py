"""Debug modes (SURVEY §5: the analog of sanitizers/race detection the
reference lacks): NaN checking and step-by-step execution.

Counterpart of `dct_carver_tpu/utils/debug.py`.  JAX runs a carve as one
jitted program; the port's counterpart of that program is the seam step's
CUDA graph (`utils/graphs.py`, `ops/carve.py::SeamSteps`), so
`disable_jit=True` makes every seam step of the calling thread run
eagerly: no capture, no step cache, one launch a kernel, the kernels
themselves unchanged.  `nan_checks=True` is the counterpart of
`jax.debug_nans`: every torch op of the thread that yields a NaN in a
floating output raises `FloatingPointError`, the seam steps run eagerly (a
capture cannot host a check that waits for the device), and the seam loops
call `check_finite` after every seam, which also covers the kernels'
in-place writes that no torch op sees.  Both switches are per thread, as
JAX's config contexts and torch's dispatch modes are.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["debug_mode", "check_finite", "eager_steps", "checks_nans"]

_STATE = threading.local()

# ops whose outputs are uninitialised memory
_UNCHECKED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
              torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
              torch.ops.aten.new_empty_strided}


def _depth(name: str) -> int:
    return getattr(_STATE, name, 0)


def eager_steps() -> bool:
    """Whether the seam steps of this thread run eagerly (inside a
    `debug_mode` block)."""
    return _depth("eager") > 0


def checks_nans() -> bool:
    """Whether this thread is inside a `debug_mode(nan_checks=True)`
    block: the seam loops then check the state after every seam."""
    return _depth("nans") > 0


@contextlib.contextmanager
def _nested(name: str):
    setattr(_STATE, name, _depth(name) + 1)
    try:
        yield
    finally:
        setattr(_STATE, name, _depth(name) - 1)


class _NanChecks(TorchDispatchMode):
    """Raise FloatingPointError when an op yields a NaN in a floating
    output; in-place ops are checked on the tensor they wrote.  Views and
    allocations of uninitialised memory are not checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.is_view or func.overloadpacket in _UNCHECKED
                or torch.Tag.inplace_view in func.tags):
            return out
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(t.isnan().any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_mode(*, nan_checks: bool = True, disable_jit: bool = False):
    """Run a block with NaN checks (energies and the DP must stay finite)
    and, with `disable_jit` or `nan_checks`, with every seam step run
    eagerly (op by op, Python-debuggable)."""
    with contextlib.ExitStack() as stack:
        if nan_checks or disable_jit:
            stack.enter_context(_nested("eager"))
        if nan_checks:
            stack.enter_context(_nested("nans"))
            stack.enter_context(_NanChecks())
        yield


def check_finite(state, where: str = "") -> None:
    """Raise FloatingPointError unless a CarveState's live columns of
    `energy` and `luma` are finite: [0, width) of each plane, or of each
    image of a (B, H, W) stack (`width` an int, or one an image)."""
    for name in ("energy", "luma"):
        x = getattr(state, name)
        width = torch.as_tensor(state.width, device=x.device).reshape(
            -1, *([1] * (x.ndim - 1)))
        live = torch.arange(x.shape[-1], device=x.device) < width
        if bool((live & ~torch.isfinite(x)).any()):
            raise FloatingPointError(f"non-finite {name} {where}")
