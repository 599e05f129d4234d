"""The port's web UI (`dct_carver_tpu_torch/ui/server.py`) on the CPU,
against the JAX package's (`dct_carver_tpu/ui/server.py`).

Both servers run over a socket on the same image, a u8 RGB image of the
structured corpus of tests/test_native.py (where JAX's jitted carve agrees
with the native f32 carver), each request goes to both, and the answers
must agree: status codes, JSON bodies and the decoded PNGs.  The stored
settings live in the test's own `DCT_CARVER_STATE_DIR`, which both
packages share.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dct_carver_tpu.ui.server import CarverApp as JApp
from dct_carver_tpu.ui.server import make_server as jmake_server
from dct_carver_tpu_torch.ui import server as tserver

from test_native import _structured_luma

H0, W0 = 40, 56


def _image():
    planes = [_structured_luma(k, H0, W0, seed=3 + i)
              for i, k in enumerate(("photo", "gradient", "edges"))]
    return (np.stack(planes, axis=-1) * 255).astype(np.uint8)


def _png(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address
    return f"http://{host}:{port}", t


@pytest.fixture
def servers(tmp_path, monkeypatch):
    """(port's base URL, JAX's base URL, the image)."""
    monkeypatch.setenv("DCT_CARVER_STATE_DIR", str(tmp_path / "state"))
    img = _image()
    srvs = [tserver.make_server(tserver.CarverApp(img, device="cpu")),
            jmake_server(JApp(img))]
    (tbase, tt), (jbase, jt) = (_serve(s) for s in srvs)
    yield tbase, jbase, img
    for s, t in zip(srvs, (tt, jt)):
        s.shutdown()
        s.server_close()
        t.join(timeout=30)
        assert not t.is_alive()


def _request(base, path, body=None):
    """(status, body bytes) of a GET, or of a POST of `body` as JSON."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _both(servers, path, body=None, png=False):
    """The port's answer to the request, checked equal to the JAX
    package's: (status, JSON body or decoded PNG)."""
    tbase, jbase, _ = servers
    (ts, tb), (js, jb) = (_request(b, path, body) for b in (tbase, jbase))
    assert ts == js, (path, ts, tb, js, jb)
    if png and ts == 200:
        got, want = _png(tb), _png(jb)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        return ts, got
    got, want = json.loads(tb), json.loads(jb)
    assert got == want, path
    return ts, got


def test_meta_image_and_page(servers):
    status, meta = _both(servers, "/api/meta")
    assert status == 200
    assert (meta["width"], meta["height"], meta["channels"]) == (W0, H0, 3)
    assert meta["max_seams_w"] == W0 - 1 and meta["max_seams_h"] == H0 - 1
    status, img = _both(servers, "/image.png", png=True)
    np.testing.assert_array_equal(img, servers[2])
    tbase, jbase, _ = servers
    assert _request(tbase, "/") == _request(jbase, "/")
    assert _request(tbase, "/index.html")[0] == 200


@pytest.mark.parametrize("blocksize,slider", [(8, 1.0), (4, 0.5), (2, 0.25),
                                              (16, 0.0)])
def test_preview(servers, blocksize, slider):
    path = f"/preview.png?blocksize={blocksize}&slider={slider}"
    if blocksize > 2 or slider in (0.0, 1.0):
        status, e = _both(servers, path, png=True)
        assert status == 200 and e.shape == (H0, W0)
        return
    # n = 2 with both weights: XLA:CPU contracts the jitted energy's
    # multiply-adds (ROADMAP Queue 3), so the port is held against the JAX
    # preview run eagerly, which rounds every op as the port does
    from dct_carver_tpu.models.carver import Carver as JCarver

    status, body = _request(servers[0], path)
    assert status == 200
    with jax.disable_jit():
        want = JCarver(servers[2], blocksize=blocksize, edges=1.0 - slider,
                       textures=slider).energy_preview()
    np.testing.assert_array_equal(_png(body), want)


def test_precompute_and_slide(servers):
    """409 before a precompute; then the slide at -max, -1, 0, +1, +max and
    past the clamps, horizontal and vertical, and the precompute's own
    clamp to dim - 1."""
    status, err = _both(servers, "/resize.png?delta=-3")
    assert status == 409 and err == {"error": "precompute first"}
    for vertical, dim in ((False, W0), (True, H0)):
        status, r = _both(servers, "/api/precompute", {
            "max_seams": 6, "blocksize": 8, "slider": 0.7,
            "vertical": vertical})
        assert status == 200 and r["max_seams"] == 6
        for delta, want in ((-6, -6), (-1, -1), (0, 0), (1, 1), (6, 6),
                            (-100, -6), (100, 6)):
            status, out = _both(servers, f"/resize.png?delta={delta}",
                                png=True)
            assert status == 200
            assert out.shape[0 if vertical else 1] == dim + want
    status, r = _both(servers, "/api/precompute", {
        "max_seams": 10**6, "blocksize": 4, "slider": 1.0, "vertical": False})
    assert r["max_seams"] == W0 - 1
    for delta in (-999, -(W0 - 1), 3, 999):
        status, out = _both(servers, f"/resize.png?delta={delta}", png=True)
        assert status == 200
    assert out.shape == (H0, 2 * W0 - 1, 3)


@pytest.mark.parametrize("params", [
    dict(seams_number=-5, blocksize=8, slider=1.0, output_energy=True,
         output_seams=True),
    dict(seams_number=4, blocksize=4, slider=0.3, output_seams=True),
    dict(seams_number=-3, blocksize=8, slider=0.7, vertically=True,
         output_energy=True, output_seams=True),
    dict(seams_number=-10**6, blocksize=8, slider=1.0),
], ids=["both-outputs", "enlarge", "vertical", "seam-clamp"])
def test_carve_and_outputs(servers, params):
    status, err = _both(servers, "/out/result.png")
    assert status == 409  # no carve yet
    status, r = _both(servers, "/api/carve", params)
    assert status == 200 and r["ok"]
    dim = H0 if params.get("vertically") else W0
    want = max(-(dim - 1), min(params["seams_number"], dim - 1))
    assert r["seams"] == want
    for name, url in r["urls"].items():
        status, out = _both(servers, url, png=True)
        assert status == 200, name
    assert set(r["urls"]) == {"result"} | {
        k for k, flag in (("energy", "output_energy"),
                          ("seams", "output_seams")) if params.get(flag)}
    # the carve stored its settings: both packages read them back
    status, meta = _both(servers, "/api/meta")
    assert meta["defaults"]["seams_number"] == want
    assert meta["defaults"]["slider"] == params["slider"]


def test_unknown_paths_and_bad_requests(servers):
    assert _both(servers, "/nope")[0] == 404
    assert _both(servers, "/api/nope", {})[0] == 404
    assert _both(servers, "/out/nope.png")[0] == 409
    # a knob out of range reaches the carver, which refuses it: a 500
    status, err = _both(servers, "/api/precompute", {
        "max_seams": 4, "blocksize": 3, "slider": 1.0, "vertical": False})
    assert status == 500 and err["error"].startswith("ValueError")


def test_no_card_raises(monkeypatch):
    """With no card visible the app, and so `serve`, raise unless the CPU
    is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _image()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserver.CarverApp(img, device=device)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserver.serve(img, port=0, device=device)
    assert tserver.CarverApp(img, device="cpu").device.type == "cpu"
