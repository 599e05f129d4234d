"""Image I/O + overlay helpers — the GIMP-host responsibilities the plugin
delegated (pixel regions `src/render.c:159-173`, seam overlay `:204-240`).

A copy of `dct_carver_tpu/utils/image.py`, which holds no JAX.  PNG/JPEG
need Pillow; PPM/PGM and `.npy` need nothing but numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_image", "save_image", "seam_overlay", "load_ppm", "save_ppm"]


def load_image(path: str) -> np.ndarray:
    """Load an image file as (H, W[, C]) uint8."""
    p = str(path)
    if p.endswith((".ppm", ".pgm", ".pnm")):
        return load_ppm(p)
    if p.endswith(".npy"):
        return np.load(p)
    from PIL import Image

    img = Image.open(p)
    if img.mode not in ("L", "RGB", "RGBA"):
        img = img.convert("RGB")
    return np.asarray(img)


def save_image(path: str, image: np.ndarray) -> None:
    p = str(path)
    image = np.asarray(image)
    if p.endswith((".ppm", ".pgm", ".pnm")):
        save_ppm(p, image)
        return
    if p.endswith(".npy"):
        np.save(p, image)
        return
    from PIL import Image

    Image.fromarray(image).save(p)


def load_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6) / PGM (P5) reader — no external deps (CLI fast path)."""
    with open(path, "rb") as f:
        data = f.read()
    fields: list[bytes] = []
    i = 0
    while len(fields) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        fields.append(data[i:j])
        i = j
        if len(fields) == 1 and fields[0] not in (b"P5", b"P6"):
            raise ValueError(f"unsupported PNM magic {fields[0]!r}")
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if maxval > 255:
        raise ValueError("16-bit PNM not supported")
    i += 1  # single whitespace after maxval
    c = 3 if magic == b"P6" else 1
    arr = np.frombuffer(data, np.uint8, count=h * w * c, offset=i)
    arr = arr.reshape((h, w, 3)) if c == 3 else arr.reshape((h, w))
    return arr.copy()


def save_ppm(path: str, image: np.ndarray) -> None:
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        header = f"P5\n{image.shape[1]} {image.shape[0]}\n255\n"
    elif image.ndim == 3 and image.shape[2] == 3:
        header = f"P6\n{image.shape[1]} {image.shape[0]}\n255\n"
    else:
        raise ValueError(f"cannot write shape {image.shape} as PNM")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(image.tobytes())


def seam_overlay(image: np.ndarray, vmap: np.ndarray) -> np.ndarray:
    """Green seam overlay, intensity = seam order / depth
    (display_carver_seams, src/render.c:204-240)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    out = img[..., :3].copy()
    depth = int(vmap.max())
    if depth == 0:
        return out
    mask = vmap > 0
    g = (255.0 * vmap.astype(np.float64) / depth).astype(np.uint8)
    out[mask] = 0
    out[..., 1][mask] = g[mask]
    return out
