"""`dct_carver_tpu_torch.api.carve(image, -n)`: one host RGB image in,
the carved host image out, on the first card (the plugin's one call,
`render()`).  `output_seams=True` hands back the visibility map that the
call copies to the host in any case."""

from benchlib.traffic import removal
from reference import carve as ref


def make_call(config: dict, traffic: dict, placement: dict):
    """The request: (1, H, W, C) images -> ((1, H, W - n, C) images,
    [(1, H, W) vmap])."""
    from dct_carver_tpu_torch import api

    n, _ = removal(config, traffic)
    knobs = config["knobs"]

    def call(images):
        r = api.carve(images[0], -n, output_seams=True, **knobs, **placement)
        return r.image[None], [r.visibility_map[None]]

    return call


def images_per_card(config: dict, traffic: dict, cards: int) -> dict:
    return {0: 1}


def reference(images, config: dict, traffic: dict, device, dtype):
    n, _ = removal(config, traffic)
    k = config["knobs"]
    ref.check_knobs(k)
    out, vmap = ref.carve(images, n, k["blocksize"], k["edges"],
                          k["textures"], device=device, dtype=dtype)
    return out, [vmap]
