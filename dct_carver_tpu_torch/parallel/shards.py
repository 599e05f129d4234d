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
  source's and before the destination's current stream).
- A reduction runs over the shard dimension of each stack; across devices
  the partials meet on the first stack's device and the result goes back.
  Every reduction of the route is exact in any order: integer sums, sums of
  one non-zero float and zeros, mins and maxes.
- The layer counts the exchanges it makes (`exchanges`), one for each
  collective the JAX program issues, so a seam step's count can be held
  against `parallel/spatial.py::collectives_per_seam`.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Stack", "ShardMesh"]


@dataclasses.dataclass(frozen=True)
class Stack:
    """Consecutive shards first .. first + count - 1 on one device."""
    device: torch.device
    first: int
    count: int


class ShardMesh:
    """`devices` (one entry a shard, repeats allowed) over a buffer `width`
    columns wide, which the shard count must divide."""

    def __init__(self, devices, width: int):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        if not self.size:
            raise ValueError("a mesh needs at least one device")
        if width % self.size:
            raise ValueError(f"width {width} is not divisible by the "
                             f"{self.size} shards")
        self.width = width
        self.Wl = width // self.size
        stacks = []
        for i, dev in enumerate(self.devices):
            if stacks and stacks[-1].device == dev:
                last = stacks.pop()
                stacks.append(Stack(dev, last.first, last.count + 1))
            else:
                stacks.append(Stack(dev, i, 1))
        self.stacks = stacks
        self.exchanges = 0

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
        whole = torch.cat([p.to(device) for p in parts])  # (S, H, Wl[, C])
        return whole.movedim(0, 1).reshape(whole.shape[1], self.width,
                                           *whole.shape[3:])

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
        dev0 = self.stacks[0].device
        whole = torch.cat([p.to(dev0, non_blocking=True) for p in parts])
        return [whole.to(st.device, non_blocking=True) for st in self.stacks]
