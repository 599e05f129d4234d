"""The comparison that decides `correct`: the program's outputs against the
plain reference's, element for element.

The program's contract is exact seams (every op rounded on its own, as
the reference's chains are), so each number compared is a count of
elements that differ, and its limit is 0: an exact comparison."""

from __future__ import annotations

import numpy as np

__all__ = ["LIMITS", "differing", "Checks"]

# the numbers compared and their limits
LIMITS = {"image_diff": 0, "vmap_diff": 0}


def differing(got, want) -> int:
    """Elements of `got` that differ from `want`; every element of the
    larger when the shapes differ, or when `got` is missing."""
    want = np.asarray(want)
    if got is None:
        return int(want.size)
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(max(got.size, want.size))
    return int(np.count_nonzero(got != want))


class Checks:
    """The running sums of the numbers compared."""

    def __init__(self):
        self.values = {k: 0 for k in LIMITS}
        self.compared = 0

    def add(self, image, want_image, vmaps, want_vmaps) -> None:
        """One sampled output: its image, and each vmap the entry returns
        (None for a pass whose vmap the entry does not give back)."""
        self.values["image_diff"] += differing(image, want_image)
        for got, want in zip(vmaps, want_vmaps):
            if got is not None:
                self.values["vmap_diff"] += differing(got, want)
        self.compared += 1

    def correct(self) -> bool:
        return self.compared > 0 and all(
            self.values[k] <= lim for k, lim in LIMITS.items())

    def report(self) -> dict:
        return {k: {"value": self.values[k], "limit": lim}
                for k, lim in LIMITS.items()}

    def lines(self) -> list:
        return [f"check {k}: {self.values[k]} (limit {lim}) over "
                f"{self.compared} sampled outputs"
                for k, lim in LIMITS.items()]
