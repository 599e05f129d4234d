"""The exchange layer of the spatial route: column shards of one image over
a mesh of devices, and the collectives between them.

Counterpart of the collectives that `dct_carver_tpu/parallel/spatial.py`
issues inside its `shard_map`: `_from_left` / `_from_right` (:108-119,
`ppermute`), `_halo_gather` with its multi-hop relay (:122-154),
`_edge_clamped_halo` (:157-189), and `psum` / `pmin` / `pmax` /
`all_gather` over the mesh axis.  The port runs the same program on one
controller: shard i of S holds global columns [i*Wl, (i+1)*Wl), and
consecutive shards on one device are held as one (S_d, ...) stack, so a
"sharded" value is a list with one tensor a stack, its leading dimension
the stack's shards, and a "replicated" value a list with one tensor a stack
holding the same value.

- A shift between shards within a stack is a slice and a concatenation;
  between devices only the boundary shard's slice moves, with
  `.to(device, non_blocking=True)` (PyTorch orders the copy after the
  source's and before the destination's current stream; inside a CUDA
  graph over several cards, `utils/graphs.py::StepGraphs`, the copy and
  those orders are nodes of the graph).
- A reduction runs over the shard dimension of each stack; across devices
  the partials meet on the first stack's device and the result goes back.
  Every reduction of the route is exact in any order: integer sums, sums of
  one non-zero float and zeros, mins and maxes.
- The layer counts the exchanges it makes (`exchanges`), one for each
  collective the JAX program issues, so a seam step's count can be held
  against `parallel/spatial.py::collectives_per_seam`.

`ProcessMesh` is the same interface over the processes of a
`torch.distributed` job (`parallel/multihost.py`), the counterpart of JAX's
multi-controller mesh: each process holds one stack, its own shards on its
one device, and the exchanges between processes are point-to-point sends
and all-reduces.  `shard_mesh` builds the one its caller asks for: a
process of a job that carves an image of its own keeps one controller.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import multihost

__all__ = ["Stack", "ShardMesh", "ProcessMesh", "shard_mesh", "shard_count"]


@dataclasses.dataclass(frozen=True)
class Stack:
    """Consecutive shards first .. first + count - 1 on one device."""
    device: torch.device
    first: int
    count: int


class ShardMesh:
    """`devices` (one entry a shard, repeats allowed) over a buffer `width`
    columns wide, which the shard count must divide."""

    rank = 0  # this process's rank in the job: one controller

    def __init__(self, devices, width: int):
        self.devices = [torch.device(d) for d in devices]
        self._layout(len(self.devices), width)
        stacks = []
        for i, dev in enumerate(self.devices):
            if stacks and stacks[-1].device == dev:
                last = stacks.pop()
                stacks.append(Stack(dev, last.first, last.count + 1))
            else:
                stacks.append(Stack(dev, i, 1))
        self.stacks = stacks

    def _layout(self, size: int, width: int) -> None:
        if not size:
            raise ValueError("a mesh needs at least one device")
        if width % size:
            raise ValueError(f"width {width} is not divisible by the "
                             f"{size} shards")
        self.size, self.width, self.Wl = size, width, width // size
        self.exchanges = 0

    def barrier(self) -> None:
        """Wait for every process of the mesh: nothing to wait for on one
        controller."""

    # ------------------------------------------------------------ layout --
    def lo(self, g: int) -> int:
        """The first global column of stack g."""
        return self.stacks[g].first * self.Wl

    def origins(self, g: int) -> torch.Tensor:
        """(S_g,) int64 on stack g's device: each shard's first column."""
        st = self.stacks[g]
        return self.Wl * torch.arange(st.first, st.first + st.count,
                                      device=st.device)

    def shard_index(self, g: int) -> torch.Tensor:
        st = self.stacks[g]
        return torch.arange(st.first, st.first + st.count, device=st.device)

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """(H, width[, C]) -> each stack's contiguous (S_g, H, Wl[, C])."""
        out = []
        for st in self.stacks:
            part = x[:, st.first * self.Wl:(st.first + st.count) * self.Wl]
            part = part.reshape(x.shape[0], st.count, self.Wl,
                                *x.shape[2:]).movedim(1, 0)
            out.append(part.to(st.device).contiguous())
        return out

    def join(self, parts: list[torch.Tensor], device=None) -> torch.Tensor:
        """The inverse of `split`, on `device` (default: the first
        stack's)."""
        device = self.stacks[0].device if device is None else device
        whole = self.every_shard(parts, device)         # (S, H, Wl[, C])
        return whole.movedim(0, 1).reshape(whole.shape[1], self.width,
                                           *whole.shape[3:])

    def every_shard(self, parts, device) -> torch.Tensor:
        """Every shard's value, (S, ...) on `device`, from each stack's
        (S_g, ...) part: on a process mesh a collective that every process
        makes, not counted in `exchanges` (the route's own all_gather is)."""
        return torch.cat([p.to(device) for p in parts])

    def replicate(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [x.to(st.device) for st in self.stacks]

    # --------------------------------------------------------- exchanges --
    def _shift(self, parts, step: int):
        self.exchanges += 1
        out = []
        for g, x in enumerate(parts):
            nb = g - step  # the stack whose boundary shard moves in
            if 0 <= nb < len(parts):
                edge = parts[nb][-1:] if step > 0 else parts[nb][:1]
                edge = edge.to(x.device, non_blocking=True)
            else:
                edge = torch.zeros_like(x[:1])
            out.append(torch.cat([edge, x[:-1]]) if step > 0
                       else torch.cat([x[1:], edge]))
        return out

    def from_left(self, parts):
        """Each shard receives x from its left neighbour (shard 0 zeros)."""
        return self._shift(parts, 1)

    def from_right(self, parts):
        """Each shard receives x from its right neighbour (the last zeros)."""
        return self._shift(parts, -1)

    def halos(self, parts, n_left: int, n_right: int):
        """The (..., n_left) and (..., n_right) neighbour column halos of
        each shard's (..., Wl) value (None where 0).  A halo within one
        shard moves only the edge columns; a wider one is relayed shard by
        shard, one exchange a hop.  Columns beyond the mesh ends arrive as
        zeros."""
        Wl = self.Wl
        left = right = None
        if n_left:
            if n_left <= Wl:
                left = self.from_left([x[..., Wl - n_left:] for x in parts])
            else:
                blocks, cur = [], parts
                for _ in range(-(-n_left // Wl)):
                    cur = self.from_left(cur)
                    blocks.append(cur)
                left = [torch.cat(b[::-1], dim=-1)[..., -n_left:]
                        for b in zip(*blocks)]
        if n_right:
            if n_right <= Wl:
                right = self.from_right([x[..., :n_right] for x in parts])
            else:
                blocks, cur = [], parts
                for _ in range(-(-n_right // Wl)):
                    cur = self.from_right(cur)
                    blocks.append(cur)
                right = [torch.cat(b, dim=-1)[..., :n_right]
                         for b in zip(*blocks)]
        return left, right

    def halo(self, parts, n_left: int, n_right: int):
        """(S, ..., Wl) -> (S, ..., n_left + Wl + n_right)."""
        left, right = self.halos(parts, n_left, n_right)
        return [torch.cat([p for p in (lh, x, rh) if p is not None], dim=-1)
                for lh, x, rh in zip(left or [None] * len(parts), parts,
                                     right or [None] * len(parts))]

    def edge_clamped_halo(self, parts, n_left: int, n_right: int):
        """`halo` with the buffer's edge clamp: columns before 0 take column
        0, columns from `width` on take column width - 1 (src/render.c:
        122-132).  The clamp applies to the halo slices only."""
        left, right = self.halos(parts, n_left, n_right)
        Wl = self.Wl
        out = []
        if left is not None:
            if n_left <= Wl:
                fill = [x[..., :1] for x in parts]
            else:  # only shard 0 holds column 0
                fill = self.psum([torch.where(
                    self._shard_mask(g, x, 0), x[..., 0], 0.0)
                    for g, x in enumerate(parts)])
                fill = [f.unsqueeze(-1) for f in fill]
            left = [torch.where(self._cols(g, x, -n_left, n_left) < 0, f, h)
                    for g, (x, f, h) in enumerate(zip(parts, fill, left))]
        if right is not None:
            if n_right <= Wl:
                fill = [x[..., -1:] for x in parts]
            else:
                fill = self.psum([torch.where(
                    self._shard_mask(g, x, self.size - 1), x[..., -1], 0.0)
                    for g, x in enumerate(parts)])
                fill = [f.unsqueeze(-1) for f in fill]
            right = [torch.where(self._cols(g, x, Wl, n_right)
                                 > self.width - 1, f, h)
                     for g, (x, f, h) in enumerate(zip(parts, fill, right))]
        for g, x in enumerate(parts):
            out.append(torch.cat(
                [p for p in (left and left[g], x, right and right[g])
                 if p is not None], dim=-1))
        return out

    def _cols(self, g: int, x, start: int, n: int) -> torch.Tensor:
        """Global columns start .. start + n - 1 past each shard's origin,
        shaped to broadcast against x's (S, ..., n) slices."""
        cols = (self.origins(g) + start)[:, None] + torch.arange(
            n, device=x.device)
        return cols.reshape(x.shape[0], *([1] * (x.ndim - 2)), n)

    def _shard_mask(self, g: int, x, index: int) -> torch.Tensor:
        mask = self.shard_index(g) == index
        return mask.reshape(x.shape[0], *([1] * (x.ndim - 2)))

    # -------------------------------------------------------- reductions --
    def _reduce(self, parts, local, combine):
        self.exchanges += 1
        partials = [local(x) for x in parts]
        total = partials[0]
        for p in partials[1:]:
            total = combine(total, p.to(total.device, non_blocking=True))
        return [total.to(st.device, non_blocking=True) for st in self.stacks]

    def psum(self, parts):
        """Sum over the shards: each stack's (S_g, ...) -> replicated (...)
        in the input's dtype."""
        return self._reduce(parts, lambda x: x.sum(0, dtype=x.dtype),
                            torch.add)

    def pmin(self, parts):
        return self._reduce(parts, lambda x: x.amin(0), torch.minimum)

    def pmax(self, parts):
        return self._reduce(parts, lambda x: x.amax(0), torch.maximum)

    def all_gather(self, parts):
        """Every shard's value on every stack: replicated (S, ...)."""
        self.exchanges += 1
        whole = self.every_shard(parts, self.stacks[0].device)
        return [whole.to(st.device, non_blocking=True) for st in self.stacks]


class ProcessMesh(ShardMesh):
    """Shards over the processes of a `torch.distributed` job: this
    process holds `devices` (its shards, all on one device), and every
    process holds as many, so process r's stack is shards r*n .. r*n + n-1
    of the global mesh.  `size` and `width` are global; `stacks` lists the
    one local stack, with its global `first`.

    A shift sends the boundary shard to the neighbouring process and
    receives the other neighbour's in one `batch_isend_irecv` (zeros at the
    mesh's ends); a reduction reduces over the local stack, then runs one
    `all_reduce`; `all_gather` and `join` give every shard to every
    process.  Under NCCL the tensors stay on the card, and a shift or a
    reduction neither waits on the host nor makes a CPU tensor, so a CUDA
    graph of the seam step holds them as nodes
    (`parallel/spatial.py::_SeamSteps`).  Under gloo, which takes CPU
    tensors, every exchanged slice of a CUDA stack is staged through host
    memory here, explicitly: this is how several processes share one card,
    which NCCL refuses, and why a gloo mesh's steps run eagerly.  Every
    process must make the same exchanges in the same order, graph replays
    included; the route's exchanges, captures and replays depend only on
    shapes and knobs that every process shares."""

    def __init__(self, devices, width: int):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.device = self.devices[0]
        if any(d != self.device for d in self.devices):
            raise ValueError(f"a process holds its shards on one device, "
                             f"got {self.devices}")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        # the backend's own memory: the card under NCCL, else the host
        self.wire = (self.device if dist.get_backend() == "nccl"
                     else torch.device("cpu"))
        n = len(self.devices)
        counts = self.every_shard([torch.tensor([n], device=self.device)],
                                   self.device).tolist()
        if any(c != n for c in counts):
            raise ValueError(f"every process must hold as many shards: "
                             f"{counts}")
        self._layout(n * self.world, width)
        self.stacks = [Stack(self.device, self.rank * n, n)]

    def barrier(self) -> None:
        multihost.barrier("mesh")

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.wire).contiguous()

    def every_shard(self, parts, device) -> torch.Tensor:
        (x,) = parts
        w = self._to_wire(x)
        out = [torch.empty_like(w) for _ in range(self.world)]
        dist.all_gather(out, w)
        return torch.cat(out).to(device)

    def _shift(self, parts, step: int):
        self.exchanges += 1
        (x,) = parts
        edge = x[-1:] if step > 0 else x[:1]  # the shard that leaves
        to, frm = self.rank + step, self.rank - step
        ops, inbox = [], None
        if 0 <= to < self.world:
            ops.append(dist.P2POp(dist.isend, self._to_wire(edge), to))
        if 0 <= frm < self.world:
            inbox = torch.empty(edge.shape, dtype=edge.dtype,
                                device=self.wire)
            ops.append(dist.P2POp(dist.irecv, inbox, frm))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        edge = (torch.zeros_like(edge) if inbox is None
                else inbox.to(self.device))
        return [torch.cat([edge, x[:-1]]) if step > 0
                else torch.cat([x[1:], edge])]

    _OPS = {torch.add: dist.ReduceOp.SUM, torch.minimum: dist.ReduceOp.MIN,
            torch.maximum: dist.ReduceOp.MAX}

    def _reduce(self, parts, local, combine):
        self.exchanges += 1
        (x,) = parts
        total = self._to_wire(local(x))
        dist.all_reduce(total, op=self._OPS[combine])
        return [total.to(self.device)]


def shard_mesh(devices, width: int, processes: bool = False) -> ShardMesh:
    """The mesh of a spatial carve: `devices` on this one controller, or
    with `processes` a `ProcessMesh`, `devices` being this process's shards
    of a mesh over every process of the `torch.distributed` job
    (`parallel/multihost.py::initialize`), as many on every process.  Only
    the caller knows which it means: a process of a job may carve an image
    of its own."""
    _processes(processes)
    return (ProcessMesh if processes else ShardMesh)(devices, width)


def shard_count(devices, processes: bool = False) -> int:
    """The global shard count of `shard_mesh(devices, ..., processes)`."""
    return len(devices) * _processes(processes)


def _processes(processes: bool) -> int:
    """The processes a mesh spans: 1 on one controller."""
    if not processes:
        return 1
    if not multihost.is_distributed():
        raise RuntimeError("processes=True needs a torch.distributed job: "
                           "call parallel/multihost.py::initialize first")
    return dist.get_world_size()
