"""`dct_carver_tpu_torch.api.carve(stack, -n, parallel="batch")` with no
devices named: a (B, H, W, C) host stack in, split over every visible
card (one chunk a card, joined on the first), the carved host stack and
its visibility maps out."""

import numpy as np

from benchlib.traffic import removal
from reference import carve as ref


def make_call(config: dict, traffic: dict, placement: dict):
    """The request: (B, H, W, C) images -> ((B, H, W - n, C) images,
    [(B, H, W) vmaps])."""
    from dct_carver_tpu_torch import api

    n, _ = removal(config, traffic)
    knobs = config["knobs"]

    def call(images):
        r = api.carve(images, -n, parallel="batch", output_seams=True,
                      **knobs, **placement)
        return r.image, [r.visibility_map]

    return call


def images_per_card(config: dict, traffic: dict, cards: int) -> dict:
    """Each card's chunk, as the batch route cuts the stack."""
    chunks = np.array_split(np.arange(int(traffic["batch"])), cards)
    return {i: len(c) for i, c in enumerate(chunks) if len(c)}


def reference(images, config: dict, traffic: dict, device, dtype):
    n, _ = removal(config, traffic)
    k = config["knobs"]
    ref.check_knobs(k)
    out, vmaps = ref.carve(images, n, k["blocksize"], k["edges"],
                           k["textures"], device=device, dtype=dtype)
    return out, [vmaps]
