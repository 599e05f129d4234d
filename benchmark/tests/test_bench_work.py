"""The least work counts against hand counts at small shapes."""

import numpy as np
import pytest

from benchlib import work


def test_dct_ops_by_hand():
    # n = 2: a vertical chain is 2 multiplies and 1 add (3 ops); 3 atoms
    assert work.dct_ops(2, outputs=1, columns=2) == (2 * 2 + 1 * 3) * 3
    # n = 8, one row of 10 energies over 10 columns
    assert work.dct_ops(8, 10, 10) == (10 * 8 + 10 * 63) * 15


def _vmap(cols_by_seam, H, W):
    """A vmap whose seam k (1-based) takes original column
    cols_by_seam[k-1][y] in row y."""
    vm = np.zeros((1, H, W), np.int32)
    for k, cols in enumerate(cols_by_seam, 1):
        for y, x in enumerate(cols):
            assert vm[0, y, x] == 0
            vm[0, y, x] = k
    return vm


def test_apply_counts_only_moved_elements():
    H, W = 2, 6
    # seam 1 at column 4 then seam 2 at original column 1 in both rows:
    # seam 1 moves 1 element a row (column 5), seam 2 moves 3 (the live
    # columns 2, 3, 5 right of it: 6 - 2 - 1)
    vm = _vmap([[4, 4], [1, 1]], H, W)
    w = work.pass_work(vm, 2, n=2)
    assert w["apply"][0] == work.APPLY_BYTES * H * (1 + 3)
    # the same seams the other way round: seam 1 at column 1 moves 4,
    # seam 2 at original 4 (position 3 of 5) moves 1
    vm = _vmap([[1, 1], [4, 4]], H, W)
    assert work.pass_work(vm, 2, n=2)["apply"][0] == \
        work.APPLY_BYTES * H * (4 + 1)


def test_find_seam_and_energy_by_hand():
    H, W, n = 3, 5, 2
    vm = _vmap([[2, 2, 2]], H, W)
    w = work.pass_work(vm, 1, n=n)
    assert w["energy"] == (8 * H * W, H * work.dct_ops(n, W, W))
    # one seam over the full live width: energy read, seam written;
    # 3 ops a cell of rows 1..
    assert w["find_seam"] == (4 * H * W + 4 * H, 3 * (H - 1) * W)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_strip_counts_the_windows_a_straight_seam_changes(n):
    # a straight seam at column c: in each row the windows whose columns
    # cross it, c - n/2 .. c + n/2 - 2 of the new image: n - 1 of them,
    # and the one band column the seam crossed
    H, W, c = 2 * n, 4 * n, 2 * n
    vm = _vmap([[c] * H], H, W)
    w = work.pass_work(vm, 1, n=n)
    outputs, columns = n - 1, 1
    assert w["strip"][1] == H * (columns * n + outputs * (n * n - 1)) * (
        2 * n - 1)


def test_strip_widens_with_the_seam_drift():
    n, H, W = 4, 8, 20
    cols = [8, 9, 10, 11, 12, 13, 14, 15]  # one column a row to the right
    w = work.pass_work(_vmap([cols], H, W), 1, n=n)
    # row y's window rows y-1 .. y+2 (clamped): spread = max - min
    spread = []
    for y in range(H):
        rows = [min(max(r, 0), H - 1) for r in range(y - 1, y + 3)]
        spread.append(max(cols[r] for r in rows) - min(cols[r] for r in rows))
    ops = sum(((s + 1) * n + (s + n - 1) * (n * n - 1)) * (2 * n - 1)
              for s in spread)
    assert w["strip"][1] == ops


def test_least_seconds_takes_the_longer_bound():
    from benchlib import peaks

    assert work.least_seconds(peaks.HBM_BYTES_PER_S, 0) == 1.0
    assert work.least_seconds(0, peaks.F32_UNFUSED_OPS_PER_S) == 1.0
