"""dct_carver_tpu_torch — the DCT-energy seam carver in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

The port of `dct_carver_tpu` (JAX/Pallas), which stays the reference it is
checked against.  It imports torch and never jax.  The main path is
`api.carve` -> `models.carver.Carver.resize` -> `ops.carve.carve_n_seams`;
the batch route, `api.carve(stack, n, parallel="batch")` ->
`parallel.mesh.carve_batch`, runs the same loop on a (B, H, W) stack.  On
CUDA tensors the loop's four steps run the kernels of `csrc/` (see
`kernels`), on CPU tensors their plain PyTorch versions.
"""

from .api import carve, CarveResult, CarverConfig

__all__ = ["carve", "CarveResult", "CarverConfig"]
