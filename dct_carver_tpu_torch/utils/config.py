"""Configuration — the reference's 9-knob PlugInVals as a dataclass.

Same fields, defaults and validation as the JAX package's
`dct_carver_tpu/utils/config.py` (reference `src/main.h:12-22`, defaults
`src/main.c:30-40`).
"""

from __future__ import annotations

import dataclasses

from ..ops.dct import BLOCKSIZES
from ..ops.dp import check_tie
from ..ops.energy_fn import resolve_energy

__all__ = ["CarverConfig"]


@dataclasses.dataclass(frozen=True)
class CarverConfig:
    # --- reference knobs (src/main.h:12-22, defaults src/main.c:30-40) ---
    edges: float = 0.0          # weight if argmax atom is (0,1)/(1,0)
    textures: float = 1.0       # weight otherwise
    blocksize: int = 8          # DCT block size: 2, 4, 8 or 16
    seams_number: int = 0       # signed: <0 remove, >0 insert
    output_energy: bool = False # also produce the normalized energy image
    output_seams: bool = False  # also produce the seam visibility map
    vertically: bool = False    # retarget HEIGHT instead of width
    # resize_canvas=FALSE analog (src/main.h:19): keep the original canvas;
    # a removal zero-fills the vacated region, an enlargement is cropped
    resize_canvas: bool = True

    # --- liblqr lqr_carver_init generalization (src/render.c:313 uses 1, 0) ---
    delta_x: int = 1            # max seam step per row (>= 1)
    rigidity: float = 0.0       # step penalty: rigidity * |dx| / delta_x
    tie: str = "leftmost"       # DP tie rule (docs/PARITY.md S1/S2)

    # --- lqr_carver_set_energy_function analog (src/render.c:314-315) ---
    # None/'dct' = the reference's DCT energy (blocksize/edges/textures);
    # a builtin name ('grad_xabs'/'grad_sumabs'/'grad_norm'/'null') or an
    # ops.energy_fn.EnergyFunction plugs a different energy into the carver.
    energy: object = None

    # --- framework knobs (no effect on carve results) ---
    luma: str = "bt709"         # "bt709" (carve path) | "bt601_studio"
    # hand-written CUDA kernels for CUDA tensors; False runs the plain
    # PyTorch versions on the same device
    use_pallas: bool = True
    strip_update: bool = True   # incremental energy updates between seams
    row_block: int | None = None  # accepted for parity; no effect here
    # "none" | "batch" (a (B, H, W[, C]) stack) | "spatial" (one image
    # column-sharded over a mesh, parallel/spatial.py) | "auto"
    parallel: str = "none"

    def __post_init__(self):
        if self.blocksize not in BLOCKSIZES:
            raise ValueError(f"blocksize must be 2/4/8/16, got {self.blocksize}")
        if not (0 <= self.edges <= 1 and 0 <= self.textures <= 1):
            raise ValueError("edges/textures must be in [0, 1]")
        if self.delta_x < 1:
            raise ValueError(f"delta_x must be >= 1, got {self.delta_x}")
        if self.rigidity < 0:
            raise ValueError(f"rigidity must be >= 0, got {self.rigidity}")
        check_tie(self.tie)
        if self.parallel not in ("none", "batch", "spatial", "auto"):
            raise ValueError(
                f"parallel must be none/batch/spatial/auto, got "
                f"{self.parallel!r}")
        self.energy_function  # validates the energy spec eagerly

    @property
    def radius(self) -> int:
        """liblqr energy-function radius = blocksize/2 (src/render.c:314),
        or the plugged energy function's own radius."""
        fn = self.energy_function
        return fn.radius if fn is not None else self.blocksize // 2

    @property
    def energy_function(self):
        """The resolved EnergyFunction, or None for the default DCT energy."""
        return resolve_energy(self.energy)
