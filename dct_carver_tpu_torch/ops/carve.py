"""The multi-seam carve loop — fixed-width buffers, logical width.

Counterpart of `dct_carver_tpu/ops/carve.py`.  Buffers keep the original
width W; the logical width tracks the live columns, and columns >= width
form a dead region that is (a) edge-filled in the luma plane, so window
clamping matches the reference's border behaviour (`src/render.c:122-132`),
and (b) masked to +inf by the DP.

Seam bookkeeping matches liblqr's visibility maps (`src/render.c:204-240`):
`vmap[y, x_original] = k` if the pixel was removed by the k-th seam, else 0.

The loop carves one (H, W) plane or a (B, H, W) stack of images of one size
(the batch route, `parallel/mesh.py`): every buffer then carries the leading
B, each step is one launch for the whole batch, and every image loses one
seam a step, so the images share one width.  A plane runs the same code as
a stack of one.

Each seam runs four steps, each one kernel on CUDA tensors (`use_pallas`)
and its plain PyTorch version otherwise: find the seam
(`kernels/dp_kernel.py`), record it in the vmap (plain gather + scatter),
compact the buffers around it (`kernels/apply_kernel.py`), and recompute
the energy in a strip around it (`kernels/strip_kernel.py`).  JAX traces
the whole carve into one jitted program; here the step runs over static
buffers (`SeamSteps`: two sets that swap every seam, the width and the
seam's label kept on the device) on the runner that every route shares
(`utils/graphs.py::GraphedSteps`), so on a card every seam after the first
is one CUDA graph replay, and a small cache keyed as the jit is
(`step_key`) keeps the buffers and graphs for the next carve of a shape.
The loop never waits for the device.

The energy after a compaction (`update_energy`, on every route) is
recomputed in a strip around the seam (`ops/strip.py`), bit for bit what a
full recompute gives (docs/PARITY.md S5).

A plugged energy (`energy_fn`, an `ops/energy_fn.py::EnergyFunction`)
replaces the DCT: its first map is `energy_fn.energy_map`, and its strip
update is three steps — gather each row's band of the compacted luma
(`kernels/strip_kernel.py::strip_gather`), the energy's own `bands_fn` on
the bands, and a scatter of the strips into the compacted energy
(`strip_scatter`).  The window size is then the energy's `n`, not
`blocksize`, for the strip extent and every guard.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import torch

from ..kernels import COUNTERS, dp_kernel
from ..kernels.apply_kernel import apply_seam
from ..kernels.energy_kernel import dct_energy
from ..kernels.strip_kernel import strip_gather, strip_scatter, strip_update
from ..utils.debug import eager_steps
from ..utils.graphs import GraphedSteps
from ..utils.profiling import span
from .dp import check_tie, find_seam as find_seam_plain, mask_energy
from .strip import ShardOffset, energy_window, strip_fits

__all__ = ["CarveState", "make_state", "carve_n_seams", "carve_seams",
           "carve_chunks", "SeamSteps", "StepParams", "step_params",
           "step_key", "kernel_dp", "cards_of", "graph_cards", "graphed",
           "update_energy", "clear_step_cache", "full_energy_map",
           "reconstruct_removed", "reconstruct_enlarged"]


class CarveState(NamedTuple):
    """Every tensor is (H, W) for one image or (B, H, W) for a stack."""
    luma: torch.Tensor     # float — current image, dead region edge-filled
    origcol: torch.Tensor  # int32 — original column of each current pixel
    vmap: torch.Tensor     # int32 — visibility map in ORIGINAL coordinates
    width: int             # logical width, shared by a stack's images
    energy: torch.Tensor   # float32 — current energy (dead region garbage)


def make_state(luma: torch.Tensor, width: int | None = None) -> CarveState:
    """`luma`: (H, W) or (B, H, W).  `width`: logical width when the buffer
    carries right padding (the pad columns must replicate the last live
    column)."""
    W = luma.shape[-1]
    dev = luma.device
    return CarveState(
        luma=luma,
        origcol=torch.arange(W, dtype=torch.int32, device=dev)
        .expand(luma.shape).contiguous(),
        vmap=torch.zeros(luma.shape, dtype=torch.int32, device=dev),
        width=W if width is None else int(width),
        energy=torch.zeros(luma.shape, dtype=torch.float32, device=dev),
    )


def full_energy_map(luma: torch.Tensor, blocksize: int, edges, textures,
                    center: str = "carve", use_pallas: bool = True,
                    energy_fn=None) -> torch.Tensor:
    """Full-image energy of a (H, W) plane or (B, H, W) stack, f32: the
    energy kernel on CUDA tensors, the plain version otherwise.  With a
    plugged `energy_fn` its own `energy_map` runs instead (plain torch, as
    the JAX package runs it in XLA)."""
    if energy_fn is not None:
        return energy_fn.energy_map(luma, center).to(torch.float32)
    return dct_energy(luma, blocksize, edges, textures, center=center,
                      use_pallas=use_pallas)


class StepParams(NamedTuple):
    """What a seam step is made of besides its buffers' shape: the
    counterpart of the JAX carve's `static_argnames`, plus what the
    kernels take by value (edges, textures, the energy's taps by
    blocksize).  Part of the step cache's key.  The spatial route's
    parameters are these and three of its own (`parallel/spatial.py`)."""
    blocksize: int
    edges: float
    textures: float
    strip_update: bool
    use_pallas: bool
    delta_x: int
    rigidity: float
    tie: str
    energy_fn: object  # an EnergyFunction, or None for the DCT energy


def step_params(blocksize, edges, textures, strip_update: bool = True,
                use_pallas: bool = True, delta_x: int = 1,
                rigidity: float = 0.0, tie: str = "leftmost",
                energy_fn=None) -> StepParams:
    """The checked parameters of a seam step on any route."""
    if delta_x < 1:
        raise ValueError(f"delta_x must be >= 1, got {delta_x}")
    check_tie(tie)
    return StepParams(int(blocksize), float(edges), float(textures),
                      bool(strip_update), bool(use_pallas), int(delta_x),
                      float(rigidity), tie, energy_fn)


def kernel_dp(p) -> bool:
    """Whether a step with parameters `p` (`StepParams`, or the spatial
    route's) takes the kernels' DP: the kernels (`use_pallas`), delta_x = 1
    and rigidity = 0.  Else it takes the plain scan, which allocates under
    capture, so its steps are never captured."""
    return p.use_pallas and p.delta_x == 1 and p.rigidity == 0.0


def cards_of(devices) -> list | None:
    """The CUDA cards among `devices`, in order and each once, or None when
    one of them is no card."""
    if any(d.type != "cuda" for d in devices):
        return None
    return list(dict.fromkeys(devices))


def graph_cards(devices, p) -> list | None:
    """The cards that a step over `devices` with `p` is captured on, the
    capturing one first, or None: every step runs eagerly.  Captured when
    every device is a card, with the kernels' DP (`kernel_dp`), outside
    `utils/debug.py::debug_mode`."""
    if not kernel_dp(p) or eager_steps():
        return None
    return cards_of(devices)


def graphed(device: torch.device, p: StepParams) -> bool:
    """Whether a step on `device` with `p` runs as CUDA graph replays."""
    return graph_cards([device], p) is not None


def update_energy(luma: torch.Tensor, energy: torch.Tensor,
                  seam: torch.Tensor, p,
                  shard: ShardOffset | None = None) -> None:
    """Bring the compacted `energy` up to date, in place, after the removal
    of `seam` left the compacted, edge-filled `luma`: the full map where
    `p` takes no strip update, else the plugged energy's strip (gather the
    bands, its `bands_fn`, scatter the strips) or the DCT strip.  luma,
    energy: (..., H, W) with (..., H) seams; with `shard`, the (S, H, Wl +
    n - 1) halo-extended luma and the (S, H, Wl) energy of a stack of
    column shards of one image, and the (H,) seam they share."""
    if not p.strip_update:
        full = full_energy_map(luma, p.blocksize, p.edges, p.textures,
                               use_pallas=p.use_pallas,
                               energy_fn=p.energy_fn)
        if shard is not None:  # the owned columns of the extended map
            r = energy_window(p.blocksize, p.energy_fn) // 2
            full = full[..., r - 1:r - 1 + energy.shape[-1]]
        energy.copy_(full)
    elif p.energy_fn is not None:
        n = p.energy_fn.n
        bands = strip_gather(luma, seam, n, delta_x=p.delta_x,
                             use_pallas=p.use_pallas, shard=shard)
        strip = p.energy_fn.bands_fn(bands.reshape(-1, *bands.shape[-2:]))
        strip = strip.to(torch.float32).reshape(*bands.shape[:-2], -1)
        strip_scatter(energy, strip.contiguous(), seam, n,
                      delta_x=p.delta_x, use_pallas=p.use_pallas,
                      shard=shard)
    else:
        strip_update(luma, energy, seam, p.blocksize, p.edges, p.textures,
                     delta_x=p.delta_x, use_pallas=p.use_pallas,
                     shard=shard)


class SeamSteps(GraphedSteps):
    """A carve's seam step over static buffers, the counterpart of the JAX
    package's jitted N-seam carve: two (luma, origcol, energy) sets that
    swap every seam, the vmap, and on the device the logical width (one
    int32 an image: (B,) for a stack, (1,) for a plane) and the next seam's
    label.  The step reads one set and writes the other, records the seam
    in the vmap with the device label (on a card, on a second stream, so
    that the graph runs the record beside the apply and the strip), then
    decrements the width and increments the label on the device.

    Graphed where `graph_cards` names the step's card; CPU tensors, the
    plain path, the plain scan DP and `debug_mode` run it eagerly.  The
    first set and the vmap are `state`'s buffers, which the step owns
    from then on; a carve whose state lies elsewhere is copied in."""

    def __init__(self, state: CarveState, p: StepParams):
        self.p = p
        planes = (state.luma, state.origcol, state.energy)
        self.vmap = state.vmap
        dev = state.luma.device
        lead = state.luma.shape[0] if state.luma.ndim == 3 else 1
        # [label, width of each image]: one add a step moves them all
        self.ctr = torch.zeros(1 + lead, dtype=torch.int32, device=dev)
        self.label, self.width = self.ctr[:1], self.ctr[1:]
        # filled on the device: a copy from the host would wait for it
        self.step_delta = torch.full((1 + lead,), -1, dtype=torch.int32,
                                     device=dev)
        self.step_delta[:1].fill_(1)
        name = p.energy_fn.name if p.energy_fn is not None else "dct"
        self.kernel_dp = kernel_dp(p) and cards_of([dev]) is not None
        super().__init__([planes, tuple(torch.empty_like(x) for x in planes)],
                         graph_cards([dev], p),
                         f"seam step (energy {name!r})", COUNTERS)
        # the vmap record's stream: in the graph, a branch beside the apply
        # and the strip, which neither read nor write what it touches
        self.side = torch.cuda.Stream(dev) if self.graph_cards is not None \
            else None

    def _find(self, energy: torch.Tensor) -> torch.Tensor:
        """The seam of each image over its live columns [0, width)."""
        p = self.p
        if self.kernel_dp:
            if energy.ndim == 3:
                return dp_kernel._find_seams_cuda(
                    dp_kernel.BATCH_KERNEL, energy, self.width, 0, p.tie)
            return dp_kernel._find_seams_cuda(
                dp_kernel.KERNEL, energy[None], self.width, 0, p.tie)[0]
        width = self.width if energy.ndim == 3 else self.width[0]
        return find_seam_plain(mask_energy(energy, width), p.delta_x,
                               p.rigidity, p.tie).to(torch.int32)

    def _step(self, src: int) -> None:
        p = self.p
        luma, origcol, energy = self.sets[src]
        out = self.sets[1 - src]
        seam = self._find(energy)
        if self.side is None:
            self._record(origcol, seam)
        else:  # the streams of the step's card, whichever card is current
            main = torch.cuda.current_stream(self.side.device)
            self.side.wait_stream(main)
            with torch.cuda.stream(self.side):
                self._record(origcol, seam)
        for o, x in zip(out, apply_seam(luma, origcol, energy, seam,
                                        self.width, out=out,
                                        use_pallas=p.use_pallas)):
            if x is not o:  # the plain version returns new tensors
                o.copy_(x)
        update_energy(out[0], out[2], seam, p)
        if self.side is not None:
            main.wait_stream(self.side)
        self.ctr.add_(self.step_delta)

    def _record(self, origcol: torch.Tensor, seam: torch.Tensor) -> None:
        """Label the seam's pixels in the vmap at their original columns
        (src/render.c:204-240)."""
        orig = origcol.gather(-1, seam[..., None].to(torch.int64))
        self.vmap.scatter_(-1, orig.to(torch.int64),
                           self.label.expand(orig.shape))

    def _checked(self, width: int) -> CarveState:
        luma, origcol, energy = self.sets[self.cur]
        return CarveState(luma, origcol, self.vmap, width, energy)

    def carve(self, state: CarveState, first: int,
              count: int) -> CarveState:
        """Seams first+1 .. first+count from `state`, copied into the
        current set unless it is that set.  The result holds this object's
        buffers.  Never waits for the device."""
        W = state.luma.shape[-1]
        # the windows of every step, checked once on host values
        if count and not 2 <= state.width - count + 1 <= state.width <= W:
            raise ValueError(f"cannot remove {count} seams from width "
                             f"{state.width} (buffer {W})")
        with span("carve.seams"):
            for dst, x in zip((*self.sets[self.cur], self.vmap),
                              (state.luma, state.origcol, state.energy,
                               state.vmap)):
                if dst.data_ptr() != x.data_ptr():
                    dst.copy_(x)
            self.label.fill_(first + 1)
            self.width.fill_(state.width)
            self.run_seams(first, state.width, count)
        return self._checked(state.width - count)


# The step cache, the counterpart of jax.jit's compile cache: the last
# CACHE_KEYS graphed steps by key, each with its buffer sets and captured
# graphs, so the next carve of a shape on the card replays from its first
# seam.  A carve takes its step out of the cache and puts it back when it
# ends, so two threads never share one step's buffers.  Steps that capture
# no graph are never kept: they gain nothing from it.  A step whose two
# sets and vmap pass CACHE_MAX_BYTES (the batch route at 256 1-Mpix images:
# ~3.2 GB a set) is made for its carve alone and captured again the next
# time, a few ms against its ~500 ms.  Both limits are a first guess, not
# fitted to traffic; what the cache holds stays allocated until
# clear_step_cache().
CACHE_KEYS = 2
CACHE_MAX_BYTES = 1 << 30
_CACHE: OrderedDict = OrderedDict()
_CACHE_LOCK = threading.Lock()


def step_key(luma: torch.Tensor, p: StepParams) -> tuple:
    """The cache key of a carve of `luma`-shaped buffers with `p`."""
    return (p, tuple(luma.shape), luma.dtype, luma.device)


def clear_step_cache() -> None:
    """Drop every cached step, its buffers and its graphs."""
    with _CACHE_LOCK:
        _CACHE.clear()


def _take_steps(luma: torch.Tensor, p: StepParams) -> SeamSteps | None:
    """Take the cached step for `luma`-shaped buffers and `p` out of the
    cache, made (with empty buffers) on a miss; None where the step would
    not be graphed or its sets and vmap would pass CACHE_MAX_BYTES."""
    if not graphed(luma.device, p):
        return None
    with _CACHE_LOCK:
        steps = _CACHE.pop(step_key(luma, p), None)
    if steps is None:
        n = luma.numel()
        # two sets of luma, int32 origcol and f32 energy; an int32 vmap
        if 2 * n * (luma.element_size() + 8) + 4 * n > CACHE_MAX_BYTES:
            return None
        with span("carve.steps.build"):
            plane = torch.empty(luma.shape, dtype=torch.int32,
                                device=luma.device)
            steps = SeamSteps(CarveState(
                torch.empty_like(luma), plane, torch.empty_like(plane),
                luma.shape[-1], torch.empty(luma.shape, dtype=torch.float32,
                                            device=luma.device)), p)
    return steps


def _keep_steps(key: tuple, steps: SeamSteps) -> None:
    with _CACHE_LOCK:
        _CACHE[key] = steps
        while len(_CACHE) > CACHE_KEYS:
            _CACHE.popitem(last=False)


def _run(steps: SeamSteps, cached: bool, state: CarveState, first: int,
         counts):
    """Yield the state after each chunk of `counts` seams.  A cached
    step's buffers are copied out, so that what is yielded aliases none,
    and the step goes back into the cache after the last chunk."""
    key = step_key(state.luma, steps.p)
    for count in counts:
        state = steps.carve(state, first, count)
        first += count
        if cached:
            state = CarveState(state.luma.clone(), state.origcol.clone(),
                               state.vmap.clone(), state.width,
                               state.energy.clone())
        yield state
    if cached:
        _keep_steps(key, steps)


def carve_chunks(state: CarveState, first: int, counts, blocksize: int,
                 edges, textures, strip_update: bool = True,
                 use_pallas: bool = True, delta_x: int = 1,
                 rigidity: float = 0.0, tie: str = "leftmost",
                 energy_fn=None):
    """Remove seams from `state`, whose buffers the carve owns, from seam
    first+1 on, in chunks of `counts` seams, and yield the state after each
    chunk.  Every chunk runs through one step of the state's shape and
    knobs (`SeamSteps`; a cached one replays the graphs it captured before,
    and a carve's chunks share one capture).  What it yields aliases no
    cached buffer.  Never waits for the device."""
    p = step_params(blocksize, edges, textures, strip_update, use_pallas,
                    delta_x, rigidity, tie, energy_fn)
    steps = _take_steps(state.luma, p)
    cached = steps is not None
    if not cached:
        with span("carve.steps.uncached"):
            steps = SeamSteps(state, p)
    return _run(steps, cached, state, first, counts)


def carve_seams(state: CarveState, first: int, count: int, blocksize: int,
                edges, textures, strip_update: bool = True,
                use_pallas: bool = True, delta_x: int = 1,
                rigidity: float = 0.0, tie: str = "leftmost",
                energy_fn=None) -> CarveState:
    """Remove seams first+1 .. first+count from `state` (`carve_chunks`
    with one chunk)."""
    for state in carve_chunks(state, first, (count,), blocksize, edges,
                              textures, strip_update, use_pallas, delta_x,
                              rigidity, tie, energy_fn):
        pass
    return state


def carve_n_seams(luma: torch.Tensor, n_seams: int, blocksize: int, edges,
                  textures, strip_update: bool = True,
                  use_pallas: bool = True, delta_x: int = 1,
                  rigidity: float = 0.0, tie: str = "leftmost",
                  energy_fn=None) -> CarveState:
    """Remove `n_seams` vertical seams from a (H, W) luma plane, or from
    each plane of a (B, H, W) stack.

    Returns the final CarveState; the caller reconstructs outputs from
    `vmap` (`reconstruct_removed` / `reconstruct_enlarged`).  The first
    energy map is computed in full; later seams use strip updates when
    enabled.  `use_pallas`: hand-written kernels for CUDA tensors (the plain
    versions run for CPU tensors, or on the card when False); on a card
    with the kernels every seam after the first is a CUDA graph replay
    (`SeamSteps`).  `delta_x`/`rigidity` other than (1, 0) take the plain
    DP.  `energy_fn`: a plugged `EnergyFunction` replacing the DCT energy
    (`blocksize`, `edges` and `textures` are then unused).
    """
    if luma.ndim not in (2, 3):
        raise ValueError(f"luma must be (H, W) or (B, H, W), got "
                         f"{tuple(luma.shape)}")
    W = luma.shape[-1]
    if not 0 <= n_seams < W:
        raise ValueError(f"cannot remove {n_seams} seams from width {W}")
    # strips wider than the buffer would index out of bounds: full
    # recompute for tiny images
    p = step_params(blocksize, edges, textures,
                    strip_update and strip_fits(W, blocksize, delta_x,
                                                energy_fn),
                    use_pallas, delta_x, rigidity, tie, energy_fn)
    steps = _take_steps(luma, p)
    cached = steps is not None
    if cached:  # the first state straight into the step's current set
        lum, origcol, _ = steps.sets[steps.cur]
        lum.copy_(luma)
        origcol.copy_(torch.arange(W, dtype=torch.int32, device=luma.device)
                      .expand(luma.shape))
        steps.vmap.zero_()
        luma = lum
    with span("carve.energy"):
        energy = full_energy_map(luma, blocksize, edges, textures,
                                 use_pallas=use_pallas, energy_fn=energy_fn)
    if cached:
        state = CarveState(luma, origcol, steps.vmap, W, energy)
    else:  # a step of this carve's own, its first set made from `luma`
        with span("carve.steps.uncached"):
            state = make_state(luma.clone())._replace(energy=energy)
            steps = SeamSteps(state, p)
    for state in _run(steps, cached, state, 0, (n_seams,)):
        pass
    return state


def reconstruct_removed(image: torch.Tensor, vmap: torch.Tensor,
                        n_seams: int) -> torch.Tensor:
    """Apply all removal seams in `vmap` to the full-channel image.

    image: (H, W[, C]) with vmap (H, W), or a stack (B, H, W[, C]) with
    vmaps (B, H, W); returns (..., H, W-n_seams[, C]).  A stable argsort
    keeps the surviving columns in order (one gather per carve).
    """
    dim = vmap.ndim - 1  # the column dimension
    W = image.shape[dim]
    removed = (vmap > 0).to(torch.uint8)
    order = torch.argsort(removed, dim=-1, stable=True)[..., : W - n_seams]
    if image.ndim > vmap.ndim:
        order = order[..., None].expand(*order.shape, image.shape[-1])
    return torch.gather(image, dim, order)


def reconstruct_enlarged(image: torch.Tensor, vmap: torch.Tensor,
                         n_seams: int) -> torch.Tensor:
    """Insert a duplicate after every seam pixel (liblqr enlargement).

    Inserted value = mean of the seam pixel and its right neighbour
    (border-clamped); round-half-up for integer dtypes.  A stack (B, H,
    W[, C]) with vmaps (B, H, W) is enlarged image by image.
    """
    if vmap.ndim == 3:
        return torch.stack([reconstruct_enlarged(im, vm, n_seams)
                            for im, vm in zip(image, vmap)])
    H, W = image.shape[:2]
    dev = image.device
    s = (vmap > 0).to(torch.int64)
    offs = torch.cumsum(s, dim=1) - s                    # exclusive cumsum
    pos = torch.arange(W, device=dev)[None, :] + offs    # out position of originals
    rows = torch.arange(H, device=dev)[:, None].expand(H, W)

    nbr = torch.cat([image[:, 1:], image[:, -1:]], dim=1)
    if image.dtype.is_floating_point:
        avg = (image + nbr) / 2
    else:
        avg = torch.div(image.to(torch.int32) + nbr.to(torch.int32) + 1, 2,
                        rounding_mode="floor").to(image.dtype)

    seam_px = s == 1
    dup_pos = torch.where(seam_px, pos + 1, pos)
    if image.ndim == 3:
        seam_px = seam_px[..., None]
    dup_val = torch.where(seam_px, avg, image)
    out = torch.zeros((H, W + n_seams) + tuple(image.shape[2:]),
                      dtype=image.dtype, device=dev)
    out[rows, pos] = image
    out[rows, dup_pos] = dup_val
    return out
