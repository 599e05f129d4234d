"""Spatially sharded single-image carving: one huge image over a mesh.

Counterpart of `dct_carver_tpu/parallel/spatial.py`, config 5 of
BASELINE.md (an 8K panorama column-sharded over the devices).  JAX runs it
as one `shard_map` program over a 1-D mesh axis; the port runs the same
program, in the same order of steps, on one controller: a mesh is a list of
torch devices (`parallel/mesh.py::make_mesh`, repeats allowed, so four
shards can share one card), shard i holds global columns [i*Wl, (i+1)*Wl),
consecutive shards on one device form one (S_d, H, Wl) stack, and the
collectives are the exchange layer of `parallel/shards.py`.  Every kernel
takes a stack, one launch for all its shards.

Per seam, with collectives blocked every K rows (K = `frontier_block`):

* DP: K-row trapezoid blocks.  One exchange pair a block ships each
  shard's Hh = 2*K*delta_x edge columns of the frontier row and the K-row
  energy block to its neighbours; the recurrence then runs K rows on the
  halo-extended width, exact on the owned columns (a value |dc| columns
  from exact data is exact for |dc| rows).  Kernel #17 (`block_dp_parts`)
  reads the four parts where they lie when the halo fits one shard; #16
  (`block_dp`) takes the message relayed over several shards otherwise;
  with `delta_x`/`rigidity` other than (1, 0), or `use_pallas=False`, the
  plain scan runs (`kernels/spatial_kernel.py::scan_rows`).
* backtrack: the tie-most global argmin of the last row (a pmin, then a
  pmin or pmax), then one K-row segment at a time from the bottom up: the
  shard owning the segment's entry column walks it in its halo-extended M
  (kernel #18), and a psum hands the segment to every shard.  The entry
  column stays on the device: the host never waits in the seam loop.
* removal: kernel #19 compacts luma, origcol and energy with the right
  neighbour's first column, shipped in one packed exchange, and gives the
  removed pixel's original column; the luma's dead region is filled on a
  static right-edge window of the last shard without a collective (the
  `dead_max` bound).  The plain path (`use_pallas=False`) is JAX's
  remove / edge-fill with its own exchanges.
* energy: one halo exchange of the compacted luma (r-1 / r columns), then
  the strip update with the shard offset (`kernels/strip_kernel.py`), each
  shard writing the overlap of each row's strip with its own columns.
* the vmap record is deferred to one scatter a chunk.

The step writes into static buffers (`_SeamSteps`): two sets of planes that
swap every seam, the extended M, and the logical width on the device, which
the step decrements.  So on one card with the kernels it is captured once a
carve in two CUDA graphs, one for each direction between the sets, and
every seam after the first replays one: the port's counterpart of the JAX
package's jitted chunk (`_spatial_chunk_jit`, `jax.jit` over `shard_map`
over `lax.fori_loop`).  CPU meshes, the plain path, the generalized DP
(`delta_x`/`rigidity` other than (1, 0)) and meshes over several cards run
the same step eagerly.

Over the processes of a `torch.distributed` job (`parallel/multihost.py`),
with `processes=True`, the mesh is a `parallel/shards.py::ProcessMesh`:
each process passes its own shards as `devices`, as many on every process,
runs the same steps
eagerly (no CUDA graph captures its collectives), and gets back the
columns it holds (`SpatialCarveResult.columns`; `gather()` assembles the
whole map on every process), the counterpart of JAX's addressable shards.

Seams equal the single-device carve's (`ops/carve.py`), element for
element.  `collectives_per_seam` is the design's exchange count per seam,
and `measure_collectives_per_seam` counts the exchanges of a real seam step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import KERNELS
from ..kernels.spatial_kernel import (block_dp, block_dp_parts, scan_rows,
                                      seg_walk, sharded_apply, walk_rows)
from ..kernels.strip_kernel import strip_update as dct_strip_update
from ..ops.carve import (ShardOffset, _update_strip_fn, full_energy_map,
                         strip_fits)
from ..ops.dp import check_tie
from ..ops.energy_fn import resolve_energy
from ..utils.debug import check_finite, checks_nans, eager_steps
from ..utils.graphs import StepGraphs
from .mesh import make_mesh
from .shards import ProcessMesh, ShardMesh, shard_count, shard_mesh

__all__ = ["spatial_carve_n_seams", "spatial_enlarge_n_seams",
           "spatial_make_state", "spatial_carve_seams", "SpatialCarveResult",
           "SpatialCarveState",
           "collectives_per_seam", "measure_collectives_per_seam",
           "FRONTIER_BLOCK"]

# Rows per DP/backtrack exchange (K), the JAX package's value: seams are
# the same for any K (trapezoid exactness); K sets the exchanges and
# launches per seam, ceil(H/K) block DPs and as many segment walks.
FRONTIER_BLOCK = 96
_INT32_MAX = 2**31 - 1


def collectives_per_seam(H: int, K: int = FRONTIER_BLOCK,
                         blocked: bool = True,
                         fused_apply: bool = False) -> int:
    """Exchanges per carved seam (single-hop halos), the JAX design's
    count: 2 per K-row DP block, 1 per K-row backtrack segment + 2 for the
    global argmin, 2 for the strip halo, the removal (3 shifts and 1 psum,
    or with the fused apply 1 packed shift) and 1 psum for the vmap record.
    Per-row design, for comparison: 3 per row."""
    nb = -(-H // K)
    if blocked:
        apply = 1 if fused_apply else (3 + 1)
        return 2 * nb + (nb + 2) + 2 + apply + 1
    return 3 * H


class SpatialCarveState(NamedTuple):
    """Mid-carve sharded state: each field but `width` is a list with one
    (S_d, H, Wl[, C]) tensor a stack of the mesh.  The carve owns these
    buffers and reuses them."""
    luma: list            # f32, dead region edge-filled
    image: list | None    # carried channels, or None
    origcol: list         # int32
    vmap: list            # int32, ORIGINAL coordinates
    energy: list          # f32
    width: int            # logical width


class SpatialCarveResult:
    """A spatial carve's outputs: on one controller every column, on a
    process mesh the columns this process holds (`columns`, `image_columns`:
    [lo, hi) of the whole planes); `gather()` gives the whole planes."""

    def __init__(self, vmap, width, image=None, capture_seconds=0.0,
                 columns=None, image_columns=None, gather=None):
        self.vmap = vmap     # (H, hi - lo) int32 on this process's device
        self.width = width   # int
        self.image = image   # compacted (H, W[, C]); columns >= width dead
        # host seconds spent capturing the seam step's CUDA graphs (0.0
        # when every step ran eagerly), inside the carve's wall time
        self.capture_seconds = capture_seconds
        self.columns = columns or (0, vmap.shape[1])
        self.image_columns = image_columns or (
            None if image is None else (0, image.shape[1]))
        self._gather = gather  # () -> (whole vmap, whole image)

    def gather(self) -> "SpatialCarveResult":
        """The result with the whole (H, W) planes on every process: a
        collective that every process of a process mesh calls; the result
        itself on one controller."""
        if self._gather is None:
            return self
        vmap, image = self._gather()
        return SpatialCarveResult(vmap, self.width, image,
                                  self.capture_seconds)


class _Params(NamedTuple):
    blocksize: int
    edges: float
    textures: float
    W: int                 # the image's own width (strip starts clamp to it)
    K: int
    strip_update: bool
    delta_x: int
    rigidity: float
    use_pallas: bool
    energy_fn: object
    tie: str
    dead_max: int | None


def _kernel_dp(p: _Params) -> bool:
    """Whether the DP and the walk take the kernels (#16-18): with the
    kernels and the kernels' DP (delta_x = 1, rigidity = 0); else the plain
    scan and walk, whose steps are never captured."""
    return p.use_pallas and p.delta_x == 1 and p.rigidity == 0.0


# ------------------------------------------------------------- energy -----

def _sharded_energy(mesh: ShardMesh, luma, p: _Params):
    """Each shard's energy, bitwise equal to the unsharded map: the
    edge-clamped r-1 / r column halo, the full map of the extended plane,
    its owned columns."""
    n = p.energy_fn.n if p.energy_fn is not None else p.blocksize
    r = n // 2
    ext = mesh.edge_clamped_halo(luma, r - 1, r)
    return [full_energy_map(x, n, p.edges, p.textures,
                            use_pallas=p.use_pallas, energy_fn=p.energy_fn)
            [..., r - 1:r - 1 + mesh.Wl].contiguous() for x in ext]


# ----------------------------------------------------------------- DP -----

def _sharded_dp(mesh: ShardMesh, E, width, p: _Params, ext_M) -> int:
    """Fill each stack's (S, H, We) `ext_M` with the blocked sharded M:
    extended column e of shard s holds global column s*Wl - Hh + e, Hh =
    2*K*delta_x.  Returns Hh."""
    H = E[0].shape[1]
    Wl, K, d = mesh.Wl, p.K, p.delta_x
    Hh = 2 * K * d
    kernels = _kernel_dp(p)
    parts = kernels and Hh <= Wl
    prev = [torch.zeros_like(e[:, 0]) for e in E]
    for r0 in range(0, H, K):
        Kb = min(K, H - r0)
        blk = [e[:, r0:r0 + Kb] for e in E]
        out = [m[:, r0:r0 + Kb] for m in ext_M]
        if parts:
            # one exchange pair ships only the Hh edge columns
            lh = mesh.from_left([torch.cat([f[:, None, Wl - Hh:],
                                            b[:, :, Wl - Hh:]], dim=1)
                                 for f, b in zip(prev, blk)])
            rh = mesh.from_right([torch.cat([f[:, None, :Hh], b[:, :, :Hh]],
                                            dim=1)
                                  for f, b in zip(prev, blk)])
            for g in range(len(E)):
                block_dp_parts(prev[g], blk[g], lh[g], rh[g], mesh.lo(g),
                               width[g], out=out[g])
        else:
            msg = mesh.halo([torch.cat([f[:, None], b], dim=1)
                             for f, b in zip(prev, blk)], Hh, Hh)
            for g in range(len(E)):
                if kernels:
                    block_dp(msg[g], mesh.lo(g), width[g], Hh, out=out[g])
                else:
                    out[g].copy_(scan_rows(msg[g], mesh.origins(g) - Hh,
                                           width[g], d, p.rigidity))
        prev = [m[:, r0 + Kb - 1, Hh:Hh + Wl] for m in ext_M]
    return Hh


# ----------------------------------------------------------- backtrack ----

def _sharded_backtrack(mesh: ShardMesh, ext_M, width, Hh: int, p: _Params):
    """The global tie-most-min seam, (H,) int32 replicated on every stack."""
    H = ext_M[0].shape[1]
    Wl, K, d = mesh.Wl, p.K, p.delta_x
    last, larg = [], []
    for g, m in enumerate(ext_M):
        org = mesh.origins(g)
        row = m[:, -1, Hh:Hh + Wl]
        row = torch.where(org[:, None] + torch.arange(Wl, device=m.device)
                          < width[g], row, math.inf)
        last.append(row)
        if p.tie == "leftmost":
            larg.append(org + row.argmin(-1))
        else:
            larg.append(org + Wl - 1 - row.flip(-1).argmin(-1))
    lmin = [x.amin(-1) for x in last]
    gmin = mesh.pmin(lmin)
    if p.tie == "leftmost":
        j = mesh.pmin([torch.where(lm == gm, la, _INT32_MAX)
                       for lm, gm, la in zip(lmin, gmin, larg)])
    else:
        j = mesh.pmax([torch.where(lm == gm, la, -1)
                       for lm, gm, la in zip(lmin, gmin, larg)])
    j = [x.to(torch.int32).reshape(1) for x in j]
    j_last = j
    kernels = _kernel_dp(p)

    def walk(r0: int, r1: int, entry):
        """Rows [r0, r1) of the seam from the entry column below them."""
        segs = []
        for g, m in enumerate(ext_M):
            rows = m[:, r0:r1]
            if kernels:
                segs.append(seg_walk(rows, entry[g], mesh.lo(g), K, Hh,
                                     tie=p.tie, use_pallas=True))
            else:
                segs.append(walk_rows(rows, entry[g], mesh.lo(g), K, Hh,
                                      p.tie, d, p.rigidity))
        return mesh.psum(segs)

    nfull, rem = divmod(H, K)
    pieces = []   # bottom-up
    if rem:
        pieces.append(walk(nfull * K - 1, H - 1, j))
        j = [s[:1] for s in pieces[-1]]
    for b in range(nfull - 1, 0, -1):
        pieces.append(walk(b * K - 1, b * K + K - 1, j))
        j = [s[:1] for s in pieces[-1]]
    if K > 1:
        pieces.append(walk(0, K - 1, j))
    return [torch.cat([pc[g] for pc in pieces[::-1]] + [j_last[g]])
            for g in range(len(ext_M))]


# ------------------------------------------------------------- removal ----

def _col_g(mesh: ShardMesh, g: int, x) -> torch.Tensor:
    """(S, 1, Wl) global columns of stack g."""
    return (mesh.origins(g)[:, None, None]
            + torch.arange(mesh.Wl, device=x.device))


def _sharded_remove(mesh: ShardMesh, parts, seam, out):
    """Compaction with the boundary pixel flowing in from the right
    neighbour, into `out` (a buffer of each part's shape a stack).  parts:
    (S, H, Wl[, C])."""
    incoming = mesh.from_right([x[:, :, :1] for x in parts])
    for g, (x, inc, o) in enumerate(zip(parts, incoming, out)):
        keep = _col_g(mesh, g, x) < seam[g][:, None]
        if x.ndim == 4:
            keep = keep[..., None]
        torch.where(keep, x, torch.cat([x[:, :, 1:], inc], dim=2), out=o)
    return out


def _sharded_edge_fill(mesh: ShardMesh, luma, width):
    """Replicate the logical edge column (global width-1) into the dead
    region, in place."""
    Wl = mesh.Wl
    picks = []
    for g, x in enumerate(luma):
        li = width[g] - 1 - mesh.origins(g)                    # (S,)
        owned = (li >= 0) & (li < Wl)
        idx = li.clamp(0, Wl - 1)[:, None, None].expand(-1, x.shape[1], 1)
        picks.append(torch.where(owned[:, None], x.gather(-1, idx)[..., 0],
                                 0.0))
    edge = mesh.psum(picks)
    for g, (x, e) in enumerate(zip(luma, edge)):
        x.copy_(torch.where(_col_g(mesh, g, x) < width[g], x, e[:, None]))


def _fused_removal(mesh: ShardMesh, st, seam, new_width, p: _Params, out):
    """Kernel #19 with the packed incoming column, into `out`'s luma,
    origcol and energy; returns orig, each stack's (H,) removed original
    columns."""
    Wl = mesh.Wl
    incoming = mesh.from_right([
        torch.cat([l[..., :1], e[..., :1], oc[..., :1].view(torch.float32)],
                  dim=-1)
        for l, e, oc in zip(st.luma, st.energy, st.origcol)])
    # the luma edge value is the new last live column's after compaction;
    # when the dead region fits a right-edge window of the last shard
    # (`dead_max`), the window below fills it with no collective, else the
    # two pre-compaction candidates are summed over the shards
    D = None if p.dead_max is None else p.dead_max + 2
    if D is not None and D > Wl:
        D = None
    if D is None:
        picks = []
        for g, x in enumerate(st.luma):
            cand = []
            for c in (new_width[g], new_width[g] - 1):
                li = c - mesh.origins(g)
                ow = (li >= 0) & (li < Wl)
                idx = li.clamp(0, Wl - 1)[:, None, None].expand(
                    -1, x.shape[1], 1)
                cand.append(torch.where(ow[:, None],
                                        x.gather(-1, idx)[..., 0], 0.0))
            picks.append(torch.stack(cand, dim=-1))
        summed = mesh.psum(picks)                               # (H, 2)
        edges = [torch.where(s == w, v[:, 1], v[:, 0])
                 for s, w, v in zip(seam, new_width, summed)]
    else:
        edges = [torch.zeros(x.shape[1], dtype=torch.float32,
                             device=x.device) for x in st.luma]
    orig_p = [sharded_apply(l, oc, e, s, ed, inc, w, mesh.lo(g),
                            out=(out.luma[g], out.origcol[g], out.energy[g]),
                            use_pallas=p.use_pallas)[3]
              for g, (l, oc, e, s, ed, inc, w) in enumerate(zip(
                  st.luma, st.origcol, st.energy, seam, edges, incoming,
                  new_width))]
    orig = mesh.psum(orig_p)
    last = mesh.stacks[-1]
    if D is not None and last.first + last.count == mesh.size:
        x = out.luma[-1][-1, :, Wl - D:]                # the last shard
        colw = mesh.width - D + torch.arange(D, device=x.device)
        ev = torch.where(colw == new_width[-1] - 1, x, 0.0).sum(-1)
        x.copy_(torch.where(colw >= new_width[-1], ev[:, None], x))
    return orig


# ------------------------------------------------------------ seam step ---

class _Planes(NamedTuple):
    """One set of the carve's sharded planes, a (S_d, H, Wl[, C]) tensor a
    stack each (`image` None when no image is carried)."""
    luma: list
    image: list | None
    origcol: list
    energy: list


def _seam_step(mesh: ShardMesh, st: _Planes, out: _Planes, width, new_width,
               p: _Params, ext_M, orig) -> None:
    """One sharded seam: DP -> backtrack -> compaction -> energy update.
    Reads `st`'s planes and writes the compacted ones into `out`'s, separate
    buffers of the same shapes, and each stack's (H,) replicated original
    column of the removed pixels into `orig`.  `width` / `new_width`: the
    logical width before and after, a one-element int32 tensor a stack.
    Allocates nothing that outlives it and never waits for the devices, so
    a CUDA graph can capture it."""
    Hh = _sharded_dp(mesh, st.energy, width, p, ext_M)
    seam = _sharded_backtrack(mesh, ext_M, width, Hh, p)
    if p.use_pallas:
        removed = _fused_removal(mesh, st, seam, new_width, p, out)
    else:
        removed = mesh.psum([
            torch.where(_col_g(mesh, g, oc) == seam[g][:, None], oc,
                        0).sum(-1, dtype=torch.int32)
            for g, oc in enumerate(st.origcol)])
        _sharded_edge_fill(mesh, _sharded_remove(mesh, st.luma, seam,
                                                 out.luma), new_width)
        _sharded_remove(mesh, st.origcol, seam, out.origcol)
        if p.strip_update:
            _sharded_remove(mesh, st.energy, seam, out.energy)
    for o, r in zip(orig, removed):
        o.copy_(r)
    if st.image is not None:
        _sharded_remove(mesh, st.image, seam, out.image)
    if p.strip_update:
        n = p.energy_fn.n if p.energy_fn is not None else p.blocksize
        ext = mesh.edge_clamped_halo(out.luma, n // 2 - 1, n // 2)
        for g in range(len(ext)):
            shard = ShardOffset(mesh.lo(g), p.W)
            if p.energy_fn is None:
                dct_strip_update(ext[g], out.energy[g], seam[g], n, p.edges,
                                 p.textures, delta_x=p.delta_x,
                                 use_pallas=p.use_pallas, shard=shard)
            else:
                _update_strip_fn(ext[g], out.energy[g], seam[g], p.energy_fn,
                                 p.delta_x, p.use_pallas, shard)
    else:
        for e, f in zip(out.energy, _sharded_energy(mesh, out.luma, p)):
            e.copy_(f)


def _record(mesh: ShardMesh, vmap, recs, base: int):
    """Write each removed pixel's seam label (base+1, base+2, ...) into the
    vmap shard owning its original column: one scatter a chunk.  recs: a
    (count, H) tensor of original columns a stack.  Original columns are
    unique and their vmap cells still 0, so adding a scattered plane is
    exact; other stacks' columns land in one spare cell."""
    for g, v in enumerate(vmap):
        cols = recs[g].to(torch.int64)                     # (count, H)
        S, H, Wl = v.shape
        count = cols.shape[0]
        local = cols - mesh.lo(g)
        rows = torch.arange(H, device=v.device)
        flat = (local // Wl) * (H * Wl) + rows * Wl + local % Wl
        flat = torch.where((local >= 0) & (local < S * Wl), flat, S * H * Wl)
        labels = (base + 1 + torch.arange(count, device=v.device,
                                          dtype=torch.int32))
        plane = torch.zeros(S * H * Wl + 1, dtype=torch.int32,
                            device=v.device)
        plane.scatter_(0, flat.reshape(-1),
                       labels[:, None].expand(count, H).reshape(-1))
        v += plane[:-1].view(S, H, Wl)


class _SeamSteps:
    """A carve's seam step over static buffers, the counterpart of JAX's
    `_spatial_chunk_jit`: two sets of planes that swap every seam, the
    halo-extended M, the logical width before and after the step on the
    device (the step decrements both), and the removed pixels' original
    columns, which are copied into a chunk's record after each step.

    On a mesh whose stacks all lie on one CUDA card, with the kernels
    and their DP (`use_pallas`, delta_x = 1, rigidity = 0), the carve's
    first seam runs eagerly, which builds the
    kernels and sets their shared-memory limits, and every later seam
    replays one of two CUDA graphs of the same step, captured once a carve
    on a side stream, one for each direction between the sets: the host
    issues one graph a seam instead of ~420 launches.  A replay credits the
    kernels' launch counts and the mesh's exchange count with what its
    capture counted.  CPU meshes, `use_pallas=False`, the generalized DP,
    meshes over several cards, process meshes and every step inside
    `utils/debug.py::debug_mode` run eagerly;
    with its NaN checks the state is checked after every seam.  A capture
    or replay that fails raises; nothing falls back to eager steps."""

    def __init__(self, mesh: ShardMesh, st: SpatialCarveState, p: _Params):
        self.mesh, self.p = mesh, p
        H = st.luma[0].shape[1]
        We = mesh.Wl + 4 * p.K * p.delta_x

        def like(xs):
            return None if xs is None else [torch.empty_like(x) for x in xs]

        self.sets = [_Planes(st.luma, st.image, st.origcol, st.energy),
                     _Planes(like(st.luma), like(st.image),
                             like(st.origcol), like(st.energy))]
        self.cur = 0
        self.ext_M = [torch.empty((x.shape[0], H, We), dtype=torch.float32,
                                  device=x.device) for x in st.luma]
        self.width, self.new_width, self.orig = (
            [torch.zeros(n, dtype=torch.int32, device=x.device)
             for x in st.luma] for n in (1, 1, H))
        # the card the step is captured on; None: every step runs eagerly
        # (a process mesh always: its collectives stay outside graphs)
        devices = {x.device for x in st.luma}
        dev = devices.pop() if len(devices) == 1 else None
        self.graph_device = dev if _kernel_dp(p) and dev is not None \
            and dev.type == "cuda" and not eager_steps() \
            and not isinstance(mesh, ProcessMesh) else None
        name = p.energy_fn.name if p.energy_fn is not None else "dct"
        self.graphs = StepGraphs(
            self.graph_device, f"spatial seam step (energy {name!r})",
            [*((k, "launches") for k in KERNELS), (mesh, "exchanges")])
        self.warm = False

    @property
    def capture_seconds(self) -> float:
        return self.graphs.capture_seconds

    def set_width(self, width: int) -> None:
        """The logical width that the next step starts from."""
        for w, nw in zip(self.width, self.new_width):
            w.fill_(width)
            nw.fill_(width - 1)

    def _step(self, src: int) -> None:
        _seam_step(self.mesh, self.sets[src], self.sets[1 - src], self.width,
                   self.new_width, self.p, self.ext_M, self.orig)
        for w, nw in zip(self.width, self.new_width):
            w.sub_(1)
            nw.sub_(1)

    def _replay(self, src: int) -> None:
        if not self.graphs.captured:
            self.graphs.capture(self._step, (self.cur, 1 - self.cur))
        self.graphs.replay(src)

    def carve(self, st: SpatialCarveState, base: int,
              count: int) -> SpatialCarveState:
        """Seams base+1 .. base+count from `st`, the state whose planes are
        this object's current set; never waits for the devices."""
        H = st.luma[0].shape[1]
        self.set_width(st.width)
        recs = [torch.empty((count, H), dtype=torch.int32, device=o.device)
                for o in self.orig]
        nan_checks = checks_nans()
        for k in range(count):
            if self.graph_device is not None and self.warm:
                self._replay(self.cur)
            else:
                self._step(self.cur)
                self.warm = True
            self.cur ^= 1
            for r, o in zip(recs, self.orig):
                r[k].copy_(o)
            if nan_checks:  # the kernels' writes, which no torch op sees
                planes = self.sets[self.cur]
                check_finite(SpatialCarveState(
                    self.mesh.join(planes.luma), None, None, None,
                    self.mesh.join(planes.energy), st.width - k - 1),
                    f"after seam {base + k + 1}")
        _record(self.mesh, st.vmap, recs, base)
        planes = self.sets[self.cur]
        return SpatialCarveState(planes.luma, planes.image, planes.origcol,
                                 st.vmap, planes.energy, st.width - count)


def _params(W: int, H: int, *, blocksize: int = 8, edges: float = 0.0,
            textures: float = 1.0, frontier_block: int = FRONTIER_BLOCK,
            strip_update: bool = True, delta_x: int = 1,
            rigidity: float = 0.0, use_pallas: bool = True, energy=None,
            tie: str = "leftmost", dead_max: int | None = None) -> _Params:
    if delta_x < 1:
        raise ValueError(f"delta_x must be >= 1, got {delta_x}")
    check_tie(tie)
    energy_fn = resolve_energy(energy)
    return _Params(int(blocksize), float(edges), float(textures), W,
                   max(1, min(frontier_block, H)),
                   strip_update and strip_fits(W, blocksize, delta_x,
                                               energy_fn),
                   int(delta_x), float(rigidity), bool(use_pallas),
                   energy_fn, tie, dead_max)


def spatial_carve_seams(state: SpatialCarveState, mesh: ShardMesh,
                        first: int, count: int, *, image_width=None,
                        **knobs) -> SpatialCarveState:
    """Remove seams first+1 .. first+count from a sharded `state` (its
    buffers are the carve's), e.g. one carried over from the JAX package
    (`utils/state.py`).  `image_width`: the image's own width before the
    carve (default: the buffer's); `knobs`: as `spatial_carve_n_seams`.
    Never waits for the devices."""
    H = state.luma[0].shape[1]
    W = mesh.width if image_width is None else int(image_width)
    p = _params(W, H, dead_max=(mesh.width - W) + first + count, **knobs)
    return _SeamSteps(mesh, state, p).carve(state, first, count)


def measure_collectives_per_seam(H: int, W: int, devices=None, *,
                                 blocksize: int = 8, edges: float = 0.0,
                                 textures: float = 1.0,
                                 frontier_block: int = FRONTIER_BLOCK,
                                 strip_update: bool = True,
                                 delta_x: int = 1, rigidity: float = 0.0,
                                 use_pallas: bool = False, seed: int = 0,
                                 processes: bool = False):
    """The exchanges of one seam step counted by the exchange layer (the
    counterpart of JAX's count of collectives in the compiled HLO), beside
    the design's count: {"total": n, "designed": collectives_per_seam}.
    `processes`: as `spatial_carve_n_seams`."""
    devices = make_mesh(devices=devices)
    if W % shard_count(devices, processes):
        raise ValueError(f"width {W} not divisible by mesh size "
                         f"{shard_count(devices, processes)}")
    luma = torch.from_numpy(np.random.default_rng(seed).random(
        (H, W), dtype=np.float32))
    p = _params(W, H, blocksize=blocksize, edges=edges, textures=textures,
                frontier_block=frontier_block, strip_update=strip_update,
                delta_x=delta_x, rigidity=rigidity, use_pallas=use_pallas,
                dead_max=64)
    st, mesh = _make_state(luma, None, devices, p, processes)
    steps = _SeamSteps(mesh, st, p)
    steps.set_width(W)
    mesh.exchanges = 0
    steps._step(0)
    return {"total": mesh.exchanges,
            "designed": collectives_per_seam(H, p.K,
                                             fused_apply=use_pallas)}


# ------------------------------------------------------------ enlargement -

def _sharded_enlarge(mesh: ShardMesh, img, vmap, n_seams: int, W: int,
                     Wlo: int):
    """Each shard's Wlo output columns of the enlarged image (liblqr
    positive-seam semantics, src/render.c:344-364): every seam pixel is
    followed by a duplicate, the rounded mean of itself and its right
    original neighbour (border-clamped); values equal
    `ops/carve.py::reconstruct_enlarged`.  Output positions come from a
    global per-row prefix sum of seam flags (one all_gather of each shard's
    row totals), and each shard reads the halo of original columns its
    output can draw from."""
    Wl, nsh = mesh.Wl, mesh.size
    sflag = [(v > 0).to(torch.int64) for v in vmap]
    local_cum = [torch.cumsum(s, dim=-1) for s in sflag]
    all_tot = mesh.all_gather([c[..., -1] for c in local_cum])  # (nsh, H)
    pos = []
    for g, (s, c, tot) in enumerate(zip(sflag, local_cum, all_tot)):
        st = mesh.stacks[g]
        left = (torch.cumsum(tot, dim=0) - tot)[st.first:st.first + st.count]
        pos.append(_col_g(mesh, g, s) + c - s + left[..., None])
    HN_l, HN_r = n_seams, n_seams + nsh
    ext_pos = mesh.halo(pos, HN_l, HN_r)
    ext_s = mesh.halo(sflag, HN_l, HN_r)
    chans = img[0].ndim == 4
    ext_img = mesh.halo([x.movedim(-1, 1) if chans else x for x in img],
                        HN_l, HN_r)
    We2 = Wl + HN_l + HN_r
    big = 1 << 30
    out = []
    for g, (ep, es, ei) in enumerate(zip(ext_pos, ext_s, ext_img)):
        dev = ep.device
        S, H = ep.shape[:2]
        slots = torch.arange(We2, device=dev)
        ecol = (mesh.origins(g) - HN_l)[:, None, None] + slots   # (S,1,We2)
        # halo slots beyond the image sort below / above every position
        ep = torch.where(ecol < 0, -big + slots, ep)
        ep = torch.where(ecol > W - 1, big + slots, ep)
        first = torch.arange(mesh.stacks[g].first,
                             mesh.stacks[g].first + S, device=dev)
        p_out = (first * Wlo)[:, None] + torch.arange(Wlo, device=dev)
        p_out = p_out[:, None].expand(S, H, Wlo).contiguous()
        i_src = (torch.searchsorted(ep.contiguous(), p_out, right=True)
                 - 1).clamp(0, We2 - 1)
        src_pos = ep.gather(-1, i_src)
        src_s = es.gather(-1, i_src)
        src_c = ecol.expand(S, H, We2).gather(-1, i_src)
        dup = (p_out == src_pos + 1) & (src_s == 1)
        i_nbr = torch.where(src_c >= W - 1, i_src, i_src + 1).clamp(
            0, We2 - 1)
        if chans:
            ei = ei.movedim(1, -1)                         # (S, H, We2, C)
            C = ei.shape[-1]
            a = ei.gather(2, i_src[..., None].expand(S, H, Wlo, C))
            b = ei.gather(2, i_nbr[..., None].expand(S, H, Wlo, C))
            dup = dup[..., None]
        else:
            a, b = ei.gather(-1, i_src), ei.gather(-1, i_nbr)
        if a.dtype.is_floating_point:
            avg = (a + b) / 2
        else:
            avg = torch.div(a.to(torch.int32) + b.to(torch.int32) + 1, 2,
                            rounding_mode="floor").to(a.dtype)
        out.append(torch.where(dup, avg, a))
    return out


# ---------------------------------------------------------- entry points ---

def _pad_to(x: torch.Tensor, Wp: int) -> torch.Tensor:
    """Edge-pad the columns (dim 1) of x to Wp."""
    pad = Wp - x.shape[1]
    if not pad:
        return x
    return torch.cat([x, x[:, -1:].expand(-1, pad, *x.shape[2:])], dim=1)


def _padded(W: int, devices, processes: bool) -> int:
    """W rounded up to a multiple of the mesh's global shard count."""
    n = shard_count(devices, processes)
    return -(-W // n) * n


def _plane(shards: torch.Tensor) -> torch.Tensor:
    """(S, H, Wo[, C]) consecutive shards -> their (H, S*Wo[, C]) plane."""
    return shards.movedim(0, 1).reshape(shards.shape[1], -1,
                                        *shards.shape[3:])


def _own_columns(mesh: ShardMesh, parts, Wo: int, total: int):
    """The columns of a plane held by this process's stacks, whose shard s
    holds columns [s*Wo, (s+1)*Wo), cut at `total`: (plane (H, hi - lo[,
    C]), (lo, hi)).  Every column on one controller."""
    home = mesh.stacks[0].device
    plane = _plane(torch.cat([x.to(home) for x in parts]))
    lo = mesh.stacks[0].first * Wo
    hi = max(lo, min(lo + plane.shape[1], total))
    return plane[:, :hi - lo], (lo, hi)


def _all_columns(mesh: ShardMesh, parts, total: int) -> torch.Tensor:
    """Every column of such a plane, on every process (a collective on a
    process mesh)."""
    return _plane(mesh.every_shard(parts, mesh.stacks[0].device))[:, :total]


def _result(mesh: ShardMesh, vmap, image, total_vmap: int, total_image,
            Wo_image: int, width: int, capture_seconds: float = 0.0):
    vm, cols = _own_columns(mesh, vmap, mesh.Wl, total_vmap)
    img = img_cols = gather = None
    if image is not None:
        img, img_cols = _own_columns(mesh, image, Wo_image, total_image)
    if isinstance(mesh, ProcessMesh):
        def gather():
            return (_all_columns(mesh, vmap, total_vmap),
                    None if image is None
                    else _all_columns(mesh, image, total_image))
    return SpatialCarveResult(vm, width, img, capture_seconds, cols,
                              img_cols, gather)


def _make_state(luma: torch.Tensor, image, devices, p: _Params,
                processes: bool):
    H, W = luma.shape
    Wp = _padded(W, devices, processes)
    mesh = shard_mesh(devices, Wp, processes)
    home = mesh.stacks[0].device
    luma_s = mesh.split(_pad_to(luma.to(home), Wp))
    origcol = mesh.split(torch.arange(Wp, dtype=torch.int32, device=home)
                         .expand(H, Wp))
    vmap = [torch.zeros_like(o) for o in origcol]
    image_s = None
    if image is not None:
        image_s = mesh.split(_pad_to(torch.as_tensor(image).to(home), Wp))
    energy = _sharded_energy(mesh, luma_s, p)
    return SpatialCarveState(luma_s, image_s, origcol, vmap, energy, W), mesh


def _as_luma(luma) -> torch.Tensor:
    luma = torch.as_tensor(np.asarray(luma) if not isinstance(
        luma, torch.Tensor) else luma)
    if luma.ndim != 2 or not luma.dtype.is_floating_point:
        raise ValueError(f"luma must be a (H, W) float plane, got "
                         f"{luma.dtype} {tuple(luma.shape)}")
    return luma.to(torch.float32)


def spatial_make_state(luma, *, blocksize: int = 8, edges: float = 0.0,
                       textures: float = 1.0, devices=None, image=None,
                       energy=None, use_pallas: bool = True,
                       processes: bool = False):
    """Shard the inputs over the mesh `devices` (default `make_mesh()`;
    `processes`: as `spatial_carve_n_seams`) and compute the first sharded
    energy.  Returns (SpatialCarveState, ShardMesh).

    Widths not divisible by the mesh size are edge-padded to the next
    multiple: the pad columns replicate the last live column, which is the
    dead-region edge fill the carve keeps after every removal, so window
    clamping reads the same values as an unpadded buffer, the DP masks the
    pad to +inf, and seams stay the same.  The logical width starts at the
    true W."""
    luma = _as_luma(luma)
    p = _params(luma.shape[1], luma.shape[0], blocksize=blocksize,
                edges=edges, textures=textures, use_pallas=use_pallas,
                energy=energy)
    return _make_state(luma, image, make_mesh(devices=devices), p,
                       processes)


def spatial_carve_n_seams(luma, n_seams: int, *, blocksize: int = 8,
                          edges: float = 0.0, textures: float = 1.0,
                          devices=None,
                          frontier_block: int = FRONTIER_BLOCK,
                          strip_update: bool = True, image=None,
                          chunk: int = 0, checkpoint_dir: str | None = None,
                          resume_from: str | None = None, delta_x: int = 1,
                          rigidity: float = 0.0, use_pallas: bool = True,
                          energy=None, progress=None,
                          tie: str = "leftmost",
                          processes: bool = False) -> SpatialCarveResult:
    """Carve `n_seams` from one column-sharded image.  `luma` (H, W), any
    W (widths the mesh does not divide are edge-padded internally, see
    `spatial_make_state`).  Returns the visibility map (original
    coordinates) and the final width; seams equal the single-device
    carve's, the generalized `delta_x`/`rigidity` DP included.

    `devices`: the mesh (`make_mesh`; default every visible card) on this
    one controller, whether or not the process is one of a job.  With
    `processes`, every process of the `torch.distributed` job
    (`parallel/multihost.py::initialize`) calls it on the same inputs, and
    `devices` are this process's shards of a mesh over all of them (a
    `ProcessMesh`): the result then holds this process's columns
    (`gather()` for all).
    `energy`: a builtin energy name or an `EnergyFunction`.  `progress`: an
    optional `utils.progress.Progress`: init before the first seam, update
    after every chunk, end on completion.  `image`: an optional (H, W[, C])
    plane carried through the sharded compaction; the returned `.image` is
    the carved image (columns < width live).  `frontier_block` (K): rows
    per DP/backtrack exchange.  `chunk` > 0 runs the seam loop in chunks of
    that many seams and waits for the devices once a chunk; with
    `checkpoint_dir` it writes a sharded checkpoint after each
    (`utils/checkpoint.py::save_sharded`), and `resume_from` restores one
    and continues.  `use_pallas`: the kernels for CUDA tensors; False runs
    the plain path (JAX's scan and remove / edge-fill forms)."""
    devices = make_mesh(devices=devices)
    luma = _as_luma(luma)
    H, W = luma.shape
    if not 0 <= n_seams < W:
        raise ValueError(f"cannot remove {n_seams} seams from width {W}")
    Wp = _padded(W, devices, processes)
    p = _params(W, H, blocksize=blocksize, edges=edges, textures=textures,
                frontier_block=frontier_block, strip_update=strip_update,
                delta_x=delta_x, rigidity=rigidity, use_pallas=use_pallas,
                energy=energy, tie=tie,
                # a bound on the dead region over the whole carve
                dead_max=(Wp - W) + n_seams)
    energy_fn = p.energy_fn
    with_image = image is not None
    # carve parameters travel with the checkpoint and are checked on resume
    params = {
        "blocksize": int(blocksize), "edges": float(edges),
        "textures": float(textures), "frontier_block": int(frontier_block),
        "strip_update": p.strip_update, "delta_x": int(delta_x),
        "rigidity": float(rigidity),
        "with_image": bool(with_image),
        "image_ndim": int(np.ndim(image)) if with_image else 0,
        "energy": energy_fn.name if energy_fn is not None else "dct",
        "tie": tie,
    }
    done = 0
    if resume_from is not None:
        from ..utils.checkpoint import load_sharded

        state, mesh, meta = load_sharded(resume_from, devices, processes)
        done = int(meta["seams_done"])
        if meta["n_seams_total"] != n_seams:
            raise ValueError(f"checkpoint was for {meta['n_seams_total']} "
                             f"seams, requested {n_seams}")
        mismatched = {k: (meta[k], v) for k, v in params.items()
                      if k in meta and meta[k] != v}
        if mismatched:
            raise ValueError(
                "checkpoint carve parameters do not match the resume "
                f"request: {mismatched} (saved, requested)")
    else:
        state, mesh = _make_state(luma, image, devices, p, processes)

    if progress is not None:
        from ..utils.i18n import _ as _t

        progress.init(_t("Resizing width..."))
        if done:
            progress.update(done / n_seams)
    step = chunk if chunk > 0 else n_seams
    steps = _SeamSteps(mesh, state, p)  # one capture serves every chunk
    while done < n_seams:
        count = min(step, n_seams - done)
        state = steps.carve(state, done, count)
        for st in mesh.stacks:
            if st.device.type == "cuda":
                torch.cuda.synchronize(st.device)
        done += count
        if progress is not None:
            progress.update(done / n_seams)
        if checkpoint_dir is not None and done < n_seams:
            from ..utils.checkpoint import save_sharded

            save_sharded(checkpoint_dir, state, mesh,
                         {"seams_done": done, "n_seams_total": n_seams,
                          **params})
    if progress is not None:
        progress.end()
    return _result(mesh, state.vmap, state.image, W, W, mesh.Wl,
                   state.width, steps.capture_seconds)


def spatial_enlarge_n_seams(luma, n_seams: int, image, *, devices=None,
                            processes: bool = False,
                            **carve_kw) -> SpatialCarveResult:
    """ENLARGE a column-sharded image by `n_seams` (the positive-seam mode
    of the reference, src/render.c:344-364): find n removal seams on a
    copy, then insert a duplicate after every seam pixel (rounded-mean
    values, liblqr semantics) with a sharded gather driven by a global
    per-row prefix sum of seam flags.  `carve_kw`: as
    `spatial_carve_n_seams`.  Returns a SpatialCarveResult whose .image is
    (H, W + n_seams[, C]) and .vmap the seam map in original coordinates;
    equal to `ops/carve.py::reconstruct_enlarged` on the single-device
    vmap."""
    devices = make_mesh(devices=devices)
    seams = spatial_carve_n_seams(luma, n_seams, devices=devices,
                                  processes=processes,
                                  **carve_kw).gather().vmap
    W = seams.shape[1]
    Wp = _padded(W, devices, processes)
    mesh = shard_mesh(devices, Wp, processes)
    home = mesh.stacks[0].device
    img = mesh.split(_pad_to(torch.as_tensor(image).to(home), Wp))
    vmap = mesh.split(torch.nn.functional.pad(seams, (0, Wp - W)))
    Wlo = -(-(W + n_seams) // mesh.size)
    out = _sharded_enlarge(mesh, img, vmap, n_seams, W, Wlo)
    return _result(mesh, vmap, out, W, W + n_seams, Wlo, W + n_seams)
