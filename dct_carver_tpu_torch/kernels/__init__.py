"""The hand-written CUDA kernels of the main path, one module each.

Each module holds one kernel's wrapper and its plain PyTorch version behind
one public function: a CUDA tensor with `use_pallas` goes to the kernel
(built from `csrc/` at first use, see `build.py`), or raises; any other
tensor goes to the plain version.  Each wrapper counts its launches on its
module's `KERNEL`.
"""

from . import apply_kernel, dp_kernel, energy_kernel, strip_kernel

__all__ = ["KERNELS", "reset_launches", "launch_counts"]

KERNELS = (energy_kernel.KERNEL, dp_kernel.KERNEL, apply_kernel.KERNEL,
           strip_kernel.KERNEL)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
