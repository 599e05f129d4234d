"""The hand-written CUDA kernels of the main path, one module each.

Each module holds one kernel's wrapper and its plain PyTorch version behind
one public function: a CUDA tensor with `use_pallas` goes to the kernel
(built from `csrc/` at first use, see `build.py`), or raises; any other
tensor goes to the plain version.  Each wrapper counts its launches on its
module's `KERNEL`; `dp_kernel.find_seams`, the batch route's DP, counts on
`dp_kernel.BATCH_KERNEL`, the tiled find-seam (where `dp_kernel.seam_route`
sends a shape; three launches a call) on `dp_kernel.TILED_KERNEL`, which
also counts the calls whose finish walked composed blocks of rows
(`blocked_finishes`) and those whose forward took the split schedule
(`split_forwards`; `COUNTERS` lists every counter, and `reset_launches`
clears them all),
`strip_kernel`'s plugged-energy strip kernels
on `GATHER_KERNEL`, `SCATTER_KERNEL` and `BAND_KERNEL`, and the spatial
route's four on `spatial_kernel`'s records, whose block DPs
(`BLOCK_KERNEL`, `PARTS_KERNEL`) also count the launches whose shards ran
in more than one column tile (`tiled_blocks`).  Every wrapper takes a (H, W)
plane or a (B, H, W) stack, one launch for the whole stack (`band_energy`
takes bands with any leading dimensions, one launch); the spatial kernels
take a stack of column shards of one image.
"""

from . import (apply_kernel, dp_kernel, energy_kernel, spatial_kernel,
               strip_kernel)

__all__ = ["KERNELS", "COUNTERS", "reset_launches", "launch_counts"]

KERNELS = (energy_kernel.KERNEL, dp_kernel.KERNEL, dp_kernel.BATCH_KERNEL,
           dp_kernel.TILED_KERNEL, apply_kernel.KERNEL, strip_kernel.KERNEL,
           strip_kernel.GATHER_KERNEL, strip_kernel.SCATTER_KERNEL,
           strip_kernel.BAND_KERNEL,
           spatial_kernel.BLOCK_KERNEL, spatial_kernel.PARTS_KERNEL,
           spatial_kernel.WALK_KERNEL, spatial_kernel.APPLY_KERNEL)

# every (record, attribute) counter the wrappers move: what a seam step's
# graph replay credits with what its capture counted (`utils/graphs.py`)
COUNTERS = (*((k, "launches") for k in KERNELS),
            (dp_kernel.TILED_KERNEL, "blocked_finishes"),
            (dp_kernel.TILED_KERNEL, "split_forwards"),
            (spatial_kernel.BLOCK_KERNEL, "tiled_blocks"),
            (spatial_kernel.PARTS_KERNEL, "tiled_blocks"))


def reset_launches() -> None:
    for k, attr in COUNTERS:
        setattr(k, attr, 0)


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
