"""A plain seam carver, written again from its definition, that the
benchmark holds the program's outputs against.

It takes the same u8 images as the program and works out everything after
them itself: the luma, the DCT energy, the seams, the visibility map and
the carved image.  It imports torch and numpy only.  It shares no code,
weights or tables with the program under test.

The semantics (the DCT-energy carve of the `avivrosenberg/dct-carver`
GIMP plugin, with the liblqr DP it drives):

* luma (liblqr's carve path): 0.2126 R + 0.7152 G + 0.0722 B, summed left
  to right, then divided by 255, each op rounded to float32 on its own;
* energy of pixel (i, j): the n x n window whose rows start at i + co and
  columns at j + co, co = -(n/2 - 1), indices clamped to the image; a 2-D
  DCT-II of it (orthonormal for n = 8, 16; unnormalized for n = 2, 4) as
  explicit chains, vertical first: V[ky] = sum over dy in order of
  D[ky, dy] * x[dy], then t[kx, ky] = sum over dx in order of
  D[kx, dx] * V[ky][dx], every multiply and add rounded on its own (no
  fused multiply-add); the energy is the largest |t| over the atoms other
  than DC, times `edges` when the atom that holds it (the largest rank
  kx * n + ky among equal values) is (0, 1) or (1, 0), else times
  `textures`;
* the DP: M[0] = E[0], M[i, j] = E[i, j] + min(M[i-1, j-1], M[i-1, j],
  M[i-1, j+1]) over the live columns; the seam ends at the leftmost
  minimum of the last row and walks up to the leftmost minimum of the
  three cells above;
* a removed seam's pixels leave the image (every plane shifts left), the
  energy is that of the new image (recomputed here in a band around the
  seam wide enough to hold every window that changed), the vmap labels
  the k-th seam's pixels k at their original columns, and the carved
  image keeps the pixels with vmap 0 in their order.

`dtype=torch.bfloat16` runs the same steps one precision lower: the
benchmark's control, which its comparison must refuse.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["dct_matrix", "luma", "energy_of_bands", "energy_map",
           "carve", "resize", "check_knobs"]

# the knobs whose other values this reference does not implement
IMPLEMENTS = {"luma": "bt709", "tie": "leftmost", "delta_x": 1,
              "rigidity": 0.0}


def check_knobs(knobs: dict) -> None:
    """Raise unless `knobs` asks for what this reference computes."""
    for k, v in IMPLEMENTS.items():
        if knobs.get(k, v) != v:
            raise ValueError(f"the reference implements {k}={v!r} only, "
                             f"not {knobs[k]!r}")


def dct_matrix(n: int) -> np.ndarray:
    """The DCT-II matrix D[k, j] of an n-point window, in float64:
    orthonormal for n in (8, 16), unnormalized for n in (2, 4)."""
    if n not in (2, 4, 8, 16):
        raise ValueError(f"window must be 2, 4, 8 or 16, got {n}")
    j = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    D = np.cos(np.pi * (j[None, :] + 0.5) * k[:, None] / n)
    if n in (8, 16):
        s = np.full(n, math.sqrt(2.0 / n))
        s[0] = math.sqrt(1.0 / n)
        D = D * s[:, None]
    return D


def luma(images: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) or (..., H, W) u8 -> (..., H, W) float32 in [0, 1]."""
    x = images.astype(np.float32)
    if x.ndim >= 3 and x.shape[-1] == 3:
        y = np.float32(0.2126) * x[..., 0] + np.float32(0.7152) * x[..., 1]
        y = y + np.float32(0.0722) * x[..., 2]
    else:
        y = x
    return y / np.float32(255.0)


def energy_of_bands(bands: torch.Tensor, n: int, edges: float,
                    textures: float) -> torch.Tensor:
    """bands (..., n, C): the n window rows over C columns -> (..., C - n
    + 1), the energy of each window whose left column is at that index."""
    dt, dev = bands.dtype, bands.device
    D = torch.tensor(dct_matrix(n), dtype=torch.float32).to(dt).to(dev)
    lead = bands.ndim - 2
    C = bands.shape[-1]
    Cout = C - n + 1
    V = D[:, 0].reshape(n, *([1] * (lead + 1))) * bands[..., 0, :]
    for dy in range(1, n):  # (n_ky, ..., C)
        V.add_(D[:, dy].reshape(n, *([1] * (lead + 1))) * bands[..., dy, :])
    T = D[:, 0].reshape(n, *([1] * (lead + 2))) * V[..., :Cout].unsqueeze(0)
    term = torch.empty_like(T)
    for dx in range(1, n):  # (n_kx, n_ky, ..., Cout)
        torch.mul(D[:, dx].reshape(n, *([1] * (lead + 2))),
                  V[..., dx:dx + Cout].unsqueeze(0), out=term)
        T.add_(term)
    del term
    A = T.abs_()
    A[0, 0] = -math.inf  # the DC atom takes no part
    A = A.reshape(n * n, *A.shape[2:])  # row kx * n + ky: the atom's rank
    best = A.amax(dim=0)
    rank = torch.arange(n * n, dtype=torch.int16, device=dev).reshape(
        n * n, *([1] * (lead + 1)))
    winner = torch.where(A == best, rank, -1).amax(dim=0)
    edge = (winner == 1) | (winner == n)
    w = torch.where(edge, torch.tensor(edges, dtype=dt, device=dev),
                    torch.tensor(textures, dtype=dt, device=dev))
    return best * w


def _bands(plane: torch.Tensor, rows: torch.Tensor,
           cols: torch.Tensor) -> torch.Tensor:
    """plane (S, H, W); rows (H, n) and cols (S, H, C) clamped indices ->
    (S, H, n, C): bands[s, i, dy, t] = plane[s, rows[i, dy], cols[s, i, t]]."""
    S = plane.shape[0]
    s = torch.arange(S, device=plane.device)[:, None, None, None]
    return plane[s, rows[None, :, :, None], cols[:, :, None, :]]


def _window_rows(H: int, n: int, device) -> torch.Tensor:
    co = -(n // 2 - 1)
    r = torch.arange(H, device=device)[:, None] + co + torch.arange(
        n, device=device)[None, :]
    return r.clamp(0, H - 1)


def energy_map(plane: torch.Tensor, n: int, edges: float, textures: float,
               rows_per_block: int | None = None) -> torch.Tensor:
    """(S, H, W) luma -> (S, H, W) energy, a block of rows at a time."""
    S, H, W = plane.shape
    co = -(n // 2 - 1)
    dev = plane.device
    if rows_per_block is None:  # the atoms' block under ~512 MiB
        per_row = n * n * S * W * plane.element_size()
        rows_per_block = max(1, (1 << 29) // per_row)
    rows = _window_rows(H, n, dev)
    cols = (torch.arange(W + n - 1, device=dev) + co).clamp(0, W - 1)
    out = torch.empty_like(plane)
    for r0 in range(0, H, rows_per_block):
        r1 = min(H, r0 + rows_per_block)
        c = cols.expand(S, r1 - r0, W + n - 1)
        out[:, r0:r1] = energy_of_bands(_bands(plane, rows[r0:r1], c), n,
                                        edges, textures)
    return out


class _Forward:
    """The DP's forward pass over static buffers: energy E (H, S, W) with
    +inf past each seam step's live width, and M (H, S, W + 2) with +inf
    borders.  On a card the H - 1 rows (two kernels each) are captured as
    one CUDA graph at the first seam of a pass and replayed at every later
    one: the same kernels, without the host's time between them."""

    def __init__(self, S: int, H: int, W: int, dtype, device):
        self.E = torch.full((H, S, W), math.inf, dtype=dtype, device=device)
        self.M = torch.full((H, S, W + 2), math.inf, dtype=dtype,
                            device=device)
        self.graph = None

    def _rows(self) -> None:
        E, M = self.E, self.M
        M[0, :, 1:-1].copy_(E[0])
        for i in range(1, E.shape[0]):
            torch.add(E[i], M[i - 1].unfold(-1, 3, 1).amin(dim=-1),
                      out=M[i, :, 1:-1])

    def __call__(self, energy: torch.Tensor) -> torch.Tensor:
        """M of the (S, H, w) live `energy`."""
        w = energy.shape[-1]
        self.E[:, :, :w].copy_(energy.transpose(0, 1))
        self.E[:, :, w:].fill_(math.inf)
        if self.E.device.type != "cuda":
            self._rows()
            return self.M
        if self.graph is None:
            side = torch.cuda.Stream(self.E.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._rows()  # warm, as a capture wants
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._rows()
        self.graph.replay()
        return self.M


def _walk(up: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """The seam's column in every row: from column j (S,) of the last row,
    row i + 1's column c leads to row i's column c + up[i, s, c] (up: (H -
    1, S, w)).  By binary lifting: the tables of jumps of 1, 2, 4, ... rows,
    each row taking the jumps of its distance's bits.  -> (S, H) int64."""
    H = up.shape[0] + 1
    S, w = up.shape[1:]
    dev = up.device
    G = up.to(torch.int64) + torch.arange(w, device=dev)  # jumps of 1 row
    dist = (H - 1) - torch.arange(H, device=dev)
    pos = j[None, :].expand(H, S).clone()
    at = torch.full((H,), H - 1, device=dev)
    s = torch.arange(S, device=dev)[None, :]
    step = 1
    while step < H:
        take = (dist & step) != 0
        r = (at - step).clamp(0, G.shape[0] - 1)
        pos = torch.where(take[:, None], G[r[:, None], s, pos], pos)
        at = torch.where(take, at - step, at)
        if 2 * step < H:  # G[r]: row r + 2 step -> row r
            G = torch.gather(G[:-step], -1, G[step:])
        step *= 2
    return pos.T


def _find_seams(energy: torch.Tensor, forward: _Forward) -> torch.Tensor:
    """(S, H, w) live energy -> (S, H) int64 seam columns."""
    S, H, w = energy.shape
    M = forward(energy)[:, :, :w + 2]
    left, mid, right = M[:-1, :, :-2], M[:-1, :, 1:-1], M[:-1, :, 2:]
    # the step to the leftmost minimum of the three cells above
    one = torch.ones((), dtype=torch.int8, device=energy.device)
    up = torch.where(left <= mid, torch.where(left <= right, -one, one),
                     torch.where(mid <= right, 0 * one, one))
    last = M[H - 1, :, 1:-1]
    col = torch.arange(w, device=energy.device)
    j = torch.where(last == last.amin(dim=-1, keepdim=True), col,
                    w).amin(dim=-1)
    return _walk(up, j)


def carve(images: np.ndarray, n_seams: int, n: int, edges: float = 0.0,
          textures: float = 1.0, device="cpu",
          dtype: torch.dtype = torch.float32):
    """Remove `n_seams` vertical seams from each image of a (S, H, W[, C])
    u8 stack.  Returns (carved (S, H, W - n_seams[, C]) u8, vmaps (S, H, W)
    int32), on the host."""
    S, H, W = images.shape[:3]
    if not 0 <= n_seams < W:
        raise ValueError(f"cannot remove {n_seams} seams from width {W}")
    dev = torch.device(device)
    plane = torch.from_numpy(luma(images)).to(dev).to(dtype)
    energy = energy_map(plane, n, edges, textures)
    orig = torch.arange(W, dtype=torch.int32, device=dev).expand(S, H, W)
    vmap = torch.zeros((S, H, W), dtype=torch.int32, device=dev)
    rows = _window_rows(H, n, dev)
    co = -(n // 2 - 1)
    half = n + 1  # every window that a removal changes lies within n
    forward = _Forward(S, H, W, dtype, dev)
    for k in range(1, n_seams + 1):
        seam = _find_seams(energy, forward)  # (S, H)
        vmap.scatter_(-1, orig.gather(-1, seam[..., None]).long(),
                      torch.full((S, H, 1), k, dtype=torch.int32,
                                 device=dev))
        w = plane.shape[-1] - 1  # the width after this removal
        col = torch.arange(w, device=dev)
        keep = col + (col >= seam[..., None])  # (S, H, w)
        plane, orig, energy = (x.gather(-1, keep) for x in
                               (plane, orig, energy))
        # recompute the band of each row around its seam
        cw = min(2 * half + 1, w)
        start = (seam - half).clamp(0, w - cw)  # (S, H)
        out_cols = start[..., None] + torch.arange(cw, device=dev)
        in_cols = (start[..., None] + co
                   + torch.arange(cw + n - 1, device=dev)).clamp(0, w - 1)
        strip = energy_of_bands(_bands(plane, rows, in_cols), n, edges,
                                textures)
        energy.scatter_(-1, out_cols, strip)
    vmap = vmap.cpu().numpy()
    kept = images[vmap == 0]
    return (kept.reshape(S, H, W - n_seams, *images.shape[3:]), vmap)


def resize(images: np.ndarray, n_width: int, n_height: int, n: int,
           edges: float = 0.0, textures: float = 1.0, device="cpu",
           dtype: torch.dtype = torch.float32):
    """Remove `n_width` columns, then `n_height` rows of the result (the
    rows as columns of its transpose).  Returns (carved, [width vmaps,
    height vmaps]); the height vmaps are in the transposed frame: (S, W -
    n_width, H)."""
    out, vw = carve(images, n_width, n, edges, textures, device, dtype)
    t = np.ascontiguousarray(np.swapaxes(out, 1, 2))
    out_t, vh = carve(t, n_height, n, edges, textures, device, dtype)
    return np.ascontiguousarray(np.swapaxes(out_t, 1, 2)), [vw, vh]
