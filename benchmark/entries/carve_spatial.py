"""`dct_carver_tpu_torch.api.carve(image, -n, parallel="spatial",
devices=[card] * shards)`: one host RGB image in, column-sharded into the
traffic's `shards` shards that one card holds as one stack (the spatial
route, `parallel/spatial.py`), the carved host image out.
`output_seams=True` hands back the visibility map that the call copies to
the host in any case.  The reference is `entries/carve.py`'s, the
single-device carve: the spatial route's seams must equal it element for
element."""

from benchlib.spec import load_module
from benchlib.traffic import removal

_CARVE = load_module("entries", "carve")
images_per_card = _CARVE.images_per_card
reference = _CARVE.reference


def make_call(config: dict, traffic: dict, placement: dict):
    """The request: (1, H, W, C) images -> ((1, H, W - n, C) images,
    [(1, H, W) vmap]).  Every shard on the placement's `device` (the first
    card when none is named)."""
    from dct_carver_tpu_torch import api

    n, _ = removal(config, traffic)
    knobs = config["knobs"]
    devices = [placement.get("device", "cuda:0")] * int(traffic["shards"])

    def call(images):
        r = api.carve(images[0], -n, output_seams=True, parallel="spatial",
                      devices=devices, **knobs)
        return r.image[None], [r.visibility_map[None]]

    return call
