"""Interactive web UI — the port's analog of the plugin's GTK dialogs.

Counterpart of `dct_carver_tpu/ui/server.py`, with the same endpoints,
status codes and clamps.  The reference has two dialogs (SURVEY §2.2/2.3):

* the main dialog (`src/interface.c:156-568`): live energy preview
  re-rendered on every knob change (`interface.c:523-525`), a blocksize
  combo {2,4,8,16} (`interface.c:281`), ONE edges<->textures slider
  (`textures = s`, `edges = 1 - s`, `interface.c:631-639`), a seams-number
  spinbutton clamped to +-(dim-1) (`interface.c:374-385`), a direction
  radio, and output checkboxes;
* the interactive-resize dialog (`interface.c:37-154`): +-N seams
  precomputed once (`interface.c:131-135`), then a width slider re-resizes
  in real time by replaying seams (`callback_resize_slider`,
  `interface.c:647-670`).

Here: a single-page web app served by a stdlib HTTP server.  The browser
is the widget toolkit; every heavy operation runs on the app's device (the
first CUDA card by default), one request at a time:

    GET  /                      the app (ui/app.html)
    GET  /api/meta              image dims + persisted defaults + clamps
    GET  /image.png             the source image
    GET  /preview.png?...       live energy preview (the `interface.c:523`
                                "invalidated" handler; preview luma+centering)
    POST /api/precompute        build an InteractiveRetargeter (+-N seams once)
    GET  /resize.png?delta=K    slide-many replay at width w0+K (one gather)
    POST /api/carve             full render() with the output checkboxes
    GET  /out/<name>.png        carve outputs (result / energy / seam map)

PNGs are encoded with Pillow, as in the JAX package and in the port's
`utils/image.py`.  Settings persist across sessions through
utils/settings.py (the gimp_set_data analog), in the store the JAX
package's UI and CLI share.
"""

from __future__ import annotations

import io
import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.placement import resolve_device

__all__ = ["CarverApp", "make_server", "serve"]

_HTML_PATH = os.path.join(os.path.dirname(__file__), "app.html")


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


class CarverApp:
    """Host-side state behind the UI: one source image, a cached retargeter
    for the slide-many path, and the last carve's outputs.  `device`: where
    every carve, preview and slide runs (default: the first CUDA card;
    raises when there is none and the CPU was not asked for)."""

    def __init__(self, image: np.ndarray, device=None):
        self.device = resolve_device(device)
        self.image = np.asarray(image)
        if self.image.ndim not in (2, 3):
            raise ValueError("image must be (H, W) or (H, W, C)")
        self.h, self.w = self.image.shape[:2]
        self._lock = threading.Lock()  # serialize device work
        self._retargeter = None
        self._retargeter_key = None
        self._outputs: dict[str, bytes] = {}

    # -- /api/meta ----------------------------------------------------------
    def meta(self) -> dict:
        from ..utils.i18n import _ as _t, get_language
        from ..utils.settings import load_last_vals

        defaults = {
            # plugin defaults, src/main.c:30-40 (slider = textures weight)
            "blocksize": 8, "slider": 1.0, "seams_number": 0,
            "vertically": False, "output_energy": False, "output_seams": False,
        }
        stored = load_last_vals()
        for k in defaults:
            if k in stored:
                defaults[k] = stored[k]
        if "textures" in stored:
            defaults["slider"] = stored["textures"]
        return {
            "width": self.w, "height": self.h,
            "channels": 1 if self.image.ndim == 2 else self.image.shape[2],
            "blocksizes": [2, 4, 8, 16],
            # spinbutton clamp, interface.c:374-385
            "max_seams_w": self.w - 1, "max_seams_h": self.h - 1,
            "defaults": defaults,
            # localized dialog labels (the gettext surface of
            # src/interface.c:310-466; utils/i18n.py catalogs)
            "language": get_language(),
            "labels": {k: _t(k) for k in (
                "Edges", "Textures", "Vertically", "Horizontally",
                "Block size", "Seams", "Output the energy image",
                "Output the seam map")},
        }

    # -- /preview.png (interface.c:523-525 -> render.c:421) ------------------
    def preview_png(self, blocksize: int, slider: float) -> bytes:
        from ..models.carver import Carver
        from ..utils.config import CarverConfig

        cfg = CarverConfig(blocksize=blocksize, edges=1.0 - slider,
                           textures=slider)
        with self._lock:
            return _png_bytes(Carver(self.image, cfg,
                                     device=self.device).energy_preview())

    # -- /api/precompute (interface.c:131-135) --------------------------------
    def precompute(self, max_seams: int, blocksize: int, slider: float,
                   vertical: bool) -> dict:
        from ..models.retarget import InteractiveRetargeter

        dim = self.h if vertical else self.w
        max_seams = max(1, min(int(max_seams), dim - 1))
        key = (max_seams, blocksize, round(float(slider), 6), vertical)
        with self._lock:
            if self._retargeter_key != key:
                self._retargeter = InteractiveRetargeter(
                    self.image, max_seams, blocksize=blocksize,
                    edges=1.0 - slider, textures=slider, vertical=vertical,
                    device=self.device,
                )
                self._retargeter_key = key
        return {"ok": True, "max_seams": max_seams, "vertical": vertical}

    # -- /resize.png (callback_resize_slider, interface.c:647-670) -----------
    def resize_png(self, delta: int) -> bytes:
        with self._lock:
            if self._retargeter is None:
                raise LookupError("precompute first")
            rt = self._retargeter
            delta = max(-rt.max_seams, min(int(delta), rt.max_seams))
            return _png_bytes(rt.at_delta(delta))

    # -- /api/carve (render(), src/render.c:327-419) --------------------------
    def carve(self, params: dict) -> dict:
        from ..api import carve
        from ..utils.image import seam_overlay
        from ..utils.settings import save_last_vals

        seams = int(params.get("seams_number", 0))
        blocksize = int(params.get("blocksize", 8))
        slider = float(params.get("slider", 1.0))
        vertically = bool(params.get("vertically", False))
        out_energy = bool(params.get("output_energy", False))
        out_seams = bool(params.get("output_seams", False))
        dim = self.h if vertically else self.w
        seams = max(-(dim - 1), min(seams, dim - 1))

        with self._lock:
            res = carve(
                self.image, seams, blocksize=blocksize,
                edges=1.0 - slider, textures=slider, vertically=vertically,
                output_energy=out_energy, output_seams=out_seams,
                device=self.device,
            )
            self._outputs["result"] = _png_bytes(res.image)
            urls = {"result": "/out/result.png"}
            if out_energy and res.energy_image is not None:
                self._outputs["energy"] = _png_bytes(res.energy_image)
                urls["energy"] = "/out/energy.png"
            if out_seams and res.visibility_map is not None:
                self._outputs["seams"] = _png_bytes(
                    seam_overlay(self.image, res.visibility_map)
                )
                urls["seams"] = "/out/seams.png"
        save_last_vals({
            "seams_number": seams, "blocksize": blocksize,
            "edges": 1.0 - slider, "textures": slider,
            "vertically": vertically, "output_energy": out_energy,
            "output_seams": out_seams,
        })
        h, w = res.image.shape[:2]
        return {"ok": True, "urls": urls, "width": w, "height": h,
                "seams": seams}

    def output_png(self, name: str) -> bytes:
        png = self._outputs.get(name)
        if png is None:
            raise LookupError(name)
        return png


class _Handler(BaseHTTPRequestHandler):
    app: CarverApp = None  # set by make_server

    def log_message(self, *a):  # quiet by default
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802 (http.server API)
        url = urllib.parse.urlparse(self.path)
        q = {k: v[0] for k, v in urllib.parse.parse_qs(url.query).items()}
        try:
            if url.path in ("/", "/index.html"):
                with open(_HTML_PATH, "rb") as f:
                    self._send(200, f.read(), "text/html; charset=utf-8")
            elif url.path == "/api/meta":
                self._json(self.app.meta())
            elif url.path == "/image.png":
                self._send(200, _png_bytes(self.app.image), "image/png")
            elif url.path == "/preview.png":
                png = self.app.preview_png(
                    int(q.get("blocksize", 8)), float(q.get("slider", 1.0))
                )
                self._send(200, png, "image/png")
            elif url.path == "/resize.png":
                png = self.app.resize_png(int(q.get("delta", 0)))
                self._send(200, png, "image/png")
            elif url.path.startswith("/out/") and url.path.endswith(".png"):
                name = url.path[len("/out/"):-len(".png")]
                self._send(200, self.app.output_png(name), "image/png")
            else:
                self._json({"error": "not found"}, 404)
        except LookupError as e:
            self._json({"error": str(e)}, 409)
        except Exception as e:  # surface device errors to the client
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    def do_POST(self):  # noqa: N802
        url = urllib.parse.urlparse(self.path)
        try:
            n = int(self.headers.get("Content-Length", "0"))
            params = json.loads(self.rfile.read(n) or b"{}")
            if url.path == "/api/precompute":
                self._json(self.app.precompute(
                    int(params.get("max_seams", 16)),
                    int(params.get("blocksize", 8)),
                    float(params.get("slider", 1.0)),
                    bool(params.get("vertical", False)),
                ))
            elif url.path == "/api/carve":
                self._json(self.app.carve(params))
            else:
                self._json({"error": "not found"}, 404)
        except Exception as e:  # surface device errors to the client
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)


def make_server(app: CarverApp, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """A ready-to-serve HTTP server bound to (host, port); port 0 = ephemeral.
    Call .serve_forever() (or serve()) to run; .server_address has the port."""
    handler = type("BoundHandler", (_Handler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)


def serve(image: np.ndarray, host: str = "127.0.0.1", port: int = 8707,
          device=None) -> None:
    """Blocking entry point used by `dct-carver-torch ui`; `device` as
    `CarverApp`'s."""
    srv = make_server(CarverApp(image, device=device), host, port)
    addr = srv.server_address
    print(f"dct-carver UI on http://{addr[0]}:{addr[1]}/", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
