"""dct_carver_tpu_torch — the DCT-energy seam carver in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

The port of `dct_carver_tpu` (JAX/Pallas), which stays the reference it is
checked against.  It imports torch and never jax.  The main path is
`api.carve` -> `models.carver.Carver.resize` -> `ops.carve.carve_n_seams`;
the batch route, `api.carve(stack, n, parallel="batch")` ->
`parallel.mesh.carve_batch`, runs the same loop on a (B, H, W) stack; the
spatial route, `api.carve(img, n, parallel="spatial")` ->
`parallel.spatial.spatial_carve_n_seams`, column-shards one image over a
mesh of devices.  On CUDA tensors every step runs a kernel of `csrc/` (see
`kernels`), on CPU tensors its plain PyTorch version.  The entry points run
on the first CUDA card unless the caller asks for the CPU.
"""

from .api import carve, CarveResult, CarverConfig

__all__ = ["carve", "CarveResult", "CarverConfig"]
