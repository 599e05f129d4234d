"""`Carver(image, CarverConfig(...)).resize(w, h)`: one host RGB image
in, the width pass then the height pass (liblqr's order, the height pass
on the transposed image with a host round trip between), the carved host
image out, on the first card.  The result holds the width pass's
visibility map only."""

from benchlib.traffic import removal
from reference import carve as ref


def make_call(config: dict, traffic: dict, placement: dict):
    """The request: (1, H, W, C) images -> ((1, H - m, W - n, C) images,
    [(1, H, W) width vmap, None])."""
    from dct_carver_tpu_torch.models.carver import Carver
    from dct_carver_tpu_torch.utils.config import CarverConfig

    nw, nh = removal(config, traffic)
    cfg = CarverConfig(output_seams=True, **config["knobs"])
    size = (config["width"] - nw, config["height"] - nh)

    def call(images):
        r = Carver(images[0], cfg, **placement).resize(*size)
        return r.image[None], [r.visibility_map[None], None]

    return call


def images_per_card(config: dict, traffic: dict, cards: int) -> dict:
    return {0: 1}


def reference(images, config: dict, traffic: dict, device, dtype):
    nw, nh = removal(config, traffic)
    k = config["knobs"]
    ref.check_knobs(k)
    return ref.resize(images, nw, nh, k["blocksize"], k["edges"],
                      k["textures"], device=device, dtype=dtype)
