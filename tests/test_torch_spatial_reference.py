"""The spatial route through the public entry, `api.carve(...,
parallel="spatial", devices=["cpu"] * 4)`, against the benchmark's plain
reference (`benchmark/reference/carve.py`, torch and numpy only): the
carved image and the vmap element for element, as the benchmark's
`pano8k_n8.spatial` cell compares them on the card.  One case's seams
cross the shard boundaries, which the test reads from the vmap."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from dct_carver_tpu_torch import api

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
SHARDS = 4


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("bench_reference_carve", "reference/carve.py")
IMAGES = _load("bench_benchlib_images", "benchlib/images.py")


def _photo(seed, H, W):
    return IMAGES.photos(seed, 1, H, W, device="cpu")


def _stripe(seed, H, W):
    """Noise with one flat diagonal stripe, 9 columns wide, from column
    W/4 - 12 at the top to W/4 + 12 at the bottom: the least energy runs
    across the boundary of shards 0 and 1."""
    img = np.random.default_rng(seed).integers(0, 256, (1, H, W, 3),
                                               np.uint8)
    lo = W // SHARDS - 12
    for y in range(H):
        c = lo + (24 * y) // H
        img[0, y, c - 4:c + 5] = 128
    return img


CASES = {
    "rgb40x256_n8": (lambda: _photo(2**31 + 11, 40, 256), 8, 8),
    "rgb48x192_n16": (lambda: _photo(2**31 + 12, 48, 192), 16, 12),
    "crossing_shards": (lambda: _stripe(2**31 + 13, 40, 256), 8, 6),
}


def _crossing_seams(vmap: np.ndarray, Wl: int) -> int:
    """Seams whose pixels lie in more than one shard."""
    return sum(len(np.unique(np.nonzero(vmap == k)[1] // Wl)) > 1
               for k in range(1, int(vmap.max()) + 1))


@pytest.mark.parametrize("case", list(CASES))
def test_spatial_route_equals_the_benchmark_reference(case):
    make, n, seams = CASES[case]
    img = make()
    got = api.carve(img[0], -seams, blocksize=n, output_seams=True,
                    parallel="spatial", devices=["cpu"] * SHARDS)
    want_image, want_vmap = REF.carve(img, seams, n)
    np.testing.assert_array_equal(got.image, want_image[0])
    np.testing.assert_array_equal(got.visibility_map, want_vmap[0])
    if case == "crossing_shards":
        Wl = img.shape[2] // SHARDS
        assert _crossing_seams(got.visibility_map, Wl) >= seams // 2
