"""The port's CLI (`dct_carver_tpu_torch/cli.py`) on the CPU, against the
JAX package's CLI on the same files.

Every test keeps the stored settings in its own `DCT_CARVER_STATE_DIR`.
The JAX CLI runs jitted, so the DCT cases use the structured images of
`make_image`, where jitted JAX agrees with the port; plugged energies use
`grad_sumabs`/`grad_xabs`, which jitted JAX computes bit for bit like the
port (ROADMAP Queue 3, the multiply-add contraction).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from dct_carver_tpu import api as japi
from dct_carver_tpu.cli import main as jmain
from dct_carver_tpu.utils import checkpoint as jckpt
from dct_carver_tpu.utils.image import load_ppm, save_ppm
from dct_carver_tpu_torch import api as tapi
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.cli import main as _tmain
from dct_carver_tpu_torch.models.carver import Carver
from dct_carver_tpu_torch.utils import checkpoint as tckpt
from dct_carver_tpu_torch.utils import i18n
from dct_carver_tpu_torch.utils.image import load_image, seam_overlay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tmain(argv):
    """The port's CLI, asked to run on the CPU (`--device cpu`; it
    raises when no card is visible and the CPU is not asked for)."""
    return _tmain([*argv, "--device", "cpu"])


@pytest.fixture
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("DCT_CARVER_STATE_DIR", str(tmp_path / "state"))
    monkeypatch.setenv("DCT_CARVER_CACHE", str(tmp_path / "xla"))
    monkeypatch.delenv("DCT_CARVER_LANG", raising=False)
    monkeypatch.setenv("LANG", "C")
    yield tmp_path
    i18n.set_language(None)


def _both(tmp_path, argv, outputs):
    """Run `argv` (with {out}-style placeholders for `outputs`) through
    both CLIs; return {name: (port file, jax file)}."""
    files = {}
    for tag, main in (("t", tmain), ("j", jmain)):
        names = {o: str(tmp_path / f"{tag}_{o}") for o in outputs}
        assert main([a.format(**names) for a in argv]) == 0, (tag, argv)
        for o, path in names.items():
            files.setdefault(o, []).append(path)
    return files


CARVE_CASES = {
    "dct removal": ["--seams", "-5"],
    "dct enlargement": ["--seams", "4", "--blocksize", "4"],
    "dct vertically": ["--seams", "-4", "--vertically", "--edges", "0.3",
                       "--textures", "0.6"],
    "no resize canvas": ["--seams", "-3", "--no-resize-canvas"],
    "tie rightmost, delta_x 2": ["--seams", "-4", "--tie", "rightmost",
                                 "--delta-x", "2", "--rigidity", "0.5"],
    "grad_sumabs": ["--seams", "-6", "--energy", "grad_sumabs"],
    "grad_xabs vertically": ["--seams", "-3", "--energy", "grad_xabs",
                             "--vertically"],
    "no strip update": ["--seams", "-4", "--no-strip-update"],
}


@pytest.mark.parametrize("case", list(CARVE_CASES))
def test_carve_equals_jax_cli(case, env, make_image):
    inp = env / "in.ppm"
    save_ppm(str(inp), make_image(20, 40, c=3, kind="edges"))
    files = _both(env, ["carve", str(inp), "{out}.ppm", "--output-seams",
                        "{seams}.ppm", "--output-energy", "{energy}.pgm",
                        *CARVE_CASES[case]],
                  ["out", "seams", "energy"])
    for name, (t, j) in files.items():
        np.testing.assert_array_equal(load_ppm(t + (".pgm" if name ==
                                                    "energy" else ".ppm")),
                                      load_ppm(j + (".pgm" if name ==
                                                    "energy" else ".ppm")),
                                      err_msg=name)


@pytest.mark.parametrize("args", [[], ["--preview", "--blocksize", "4"],
                                  ["--energy", "grad_xabs", "--vertically"],
                                  ["--energy", "grad_sumabs"]])
def test_energy_equals_jax_cli(args, env, make_image):
    inp = env / "in.png"
    from PIL import Image

    Image.fromarray(make_image(24, 36, c=3)).save(inp)
    files = _both(env, ["energy", str(inp), "{e}.png", *args], ["e"])
    t, j = files["e"]
    np.testing.assert_array_equal(load_image(t + ".png"),
                                  load_image(j + ".png"))


def test_batch_equals_jax_cli(env, make_image):
    src = env / "src"
    src.mkdir()
    imgs = [make_image(16, 32, c=3) for _ in range(3)]
    for i, im in enumerate(imgs):
        save_ppm(str(src / f"im{i}.ppm"), im)
    for tag, main in (("t", tmain), ("j", jmain)):
        assert main(["batch", str(src), str(env / tag), "--seams", "4",
                     "--energy", "grad_sumabs"]) == 0
    for i in range(3):
        t = load_ppm(str(env / "t" / f"im{i}.ppm"))
        assert t.shape == (16, 28, 3)
        np.testing.assert_array_equal(t, load_ppm(str(env / "j" /
                                                      f"im{i}.ppm")))
        np.testing.assert_array_equal(
            t, tapi.carve(imgs[i], -4, energy="grad_sumabs",
                          device="cpu").image)


def test_batch_rejects_mixed_sizes_and_empty_dirs(env, make_image, capsys):
    src = env / "src"
    src.mkdir()
    assert tmain(["batch", str(src), str(env / "o"), "--seams", "2"]) == 1
    save_ppm(str(src / "a.ppm"), make_image(8, 16, c=3))
    save_ppm(str(src / "b.ppm"), make_image(8, 18, c=3))
    assert tmain(["batch", str(src), str(env / "o"), "--seams", "2"]) == 1
    assert "identically-sized" in capsys.readouterr().err


def test_last_vals_equal_jax_and_drop_energy(env, make_image):
    """`--last-vals` reruns with the stored knobs.  Both packages store the
    reference's knobs only, without `energy` or `tie` (ROADMAP Queue 3):
    the rerun takes the DCT energy."""
    inp = env / "in.ppm"
    img = make_image(20, 30, c=3)
    save_ppm(str(inp), img)
    for tag, main in (("t", tmain), ("j", jmain)):
        assert main(["carve", str(inp), str(env / f"{tag}1.ppm"), "--seams",
                     "-5", "--blocksize", "4", "--energy",
                     "grad_sumabs"]) == 0
        assert main(["carve", str(inp), str(env / f"{tag}2.ppm"),
                     "--last-vals"]) == 0
    np.testing.assert_array_equal(load_ppm(str(env / "t1.ppm")),
                                  load_ppm(str(env / "j1.ppm")))
    np.testing.assert_array_equal(load_ppm(str(env / "t2.ppm")),
                                  load_ppm(str(env / "j2.ppm")))
    np.testing.assert_array_equal(
        load_ppm(str(env / "t2.ppm")),
        tapi.carve(img, -5, blocksize=4, device="cpu").image)


def test_last_vals_without_history(env, make_image, capsys):
    inp = env / "in.ppm"
    save_ppm(str(inp), make_image(10, 12, c=3))
    assert tmain(["carve", str(inp), str(env / "o.ppm"), "--last-vals"]) == 1
    assert tmain(["carve", str(inp), str(env / "o.ppm")]) == 1  # no seams
    err = capsys.readouterr().err
    assert "no saved settings" in err and "--seams is required" in err


def test_zero_seams_keep_the_energy_and_axis(env, make_image):
    """`--seams 0` passes every knob through: the exported energy is the
    plugged one, along the requested axis.  (The JAX CLI drops `energy`,
    `vertically` and `tie` here, ROADMAP Queue 3; the port is held against
    the JAX API, the documented contract.)"""
    img = make_image(18, 26, c=3)
    inp = env / "in.ppm"
    save_ppm(str(inp), img)
    assert tmain(["carve", str(inp), str(env / "o.ppm"), "--seams", "0",
                  "--energy", "grad_xabs", "--vertically",
                  "--output-energy", str(env / "e.pgm"),
                  "--output-seams", str(env / "s.ppm")]) == 0
    np.testing.assert_array_equal(load_ppm(str(env / "o.ppm")), img)
    want = japi.carve(img, 0, energy="grad_xabs", vertically=True,
                      output_energy=True)
    np.testing.assert_array_equal(load_ppm(str(env / "e.pgm")),
                                  want.energy_image)
    np.testing.assert_array_equal(load_ppm(str(env / "s.ppm")), img)


def test_checkpoint_resume_and_progress(env, make_image, capsys,
                                        monkeypatch):
    """A checkpointed carve with progress equals the plain one; a carve
    resumed from a mid-carve checkpoint (the port's or the JAX package's)
    ends where the uninterrupted carve ends."""
    img = make_image(24, 48, c=3)
    inp = env / "in.ppm"
    save_ppm(str(inp), img)
    knobs = ["--seams", "-8", "--energy", "grad_sumabs"]
    assert tmain(["carve", str(inp), str(env / "ref.ppm"), *knobs]) == 0
    # keep the checkpoint after 6 of 8 seams, as an interruption would
    saved = []
    real_save = tckpt.save_state

    def save_and_copy(path, state, config, done, total):
        real_save(path, state, config, done, total)
        if done == 6:
            real_save(str(env / "ck6.npz"), state, config, done, total)
        saved.append(done)

    monkeypatch.setattr(tckpt, "save_state", save_and_copy)
    assert tmain(["carve", str(inp), str(env / "out.ppm"), *knobs,
                  "--checkpoint", str(env / "ck.npz"), "--checkpoint-every",
                  "3", "--progress"]) == 0
    assert saved == [3, 6, 8]
    err = capsys.readouterr().err
    assert "Resizing width..." in err and "100.0%" in err
    ref = load_ppm(str(env / "ref.ppm"))
    np.testing.assert_array_equal(load_ppm(str(env / "out.ppm")), ref)
    np.testing.assert_array_equal(
        ref, japi.carve(img, -8, energy="grad_sumabs").image)
    assert tmain(["carve", str(inp), str(env / "res.ppm"), *knobs,
                  "--resume", str(env / "ck6.npz")]) == 0
    np.testing.assert_array_equal(load_ppm(str(env / "res.ppm")), ref)
    # the JAX package reads the port's checkpoint, and the other way round
    state, cfg, done, total = jckpt.load_state(str(env / "ck6.npz"))
    assert (done, total, int(state.width), cfg.energy) == (
        6, 8, 42, "grad_sumabs")
    jckpt.save_state(str(env / "jck6.npz"), state, cfg, done, total)
    assert tmain(["carve", str(inp), str(env / "jres.ppm"), *knobs,
                  "--resume", str(env / "jck6.npz")]) == 0
    np.testing.assert_array_equal(load_ppm(str(env / "jres.ppm")), ref)


def test_summary_line_and_overlay(env, make_image, capsys):
    import json

    img = make_image(16, 30, c=3)
    inp = env / "in.ppm"
    save_ppm(str(inp), img)
    kernels.reset_launches()
    assert tmain(["carve", str(inp), str(env / "o.ppm"), "--seams", "-4",
                  "--energy", "grad_norm", "--output-seams",
                  str(env / "s.ppm")]) == 0
    assert sum(kernels.launch_counts().values()) == 0  # the CPU: no kernel
    line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert line["input"] == [16, 30, 3] and line["output"] == [16, 26, 3]
    assert line["seams"] == -4 and line["seconds"] >= 0
    res = Carver(img, energy="grad_norm", output_seams=True,
                 device="cpu").resize(26, 16)
    np.testing.assert_array_equal(load_ppm(str(env / "o.ppm")), res.image)
    np.testing.assert_array_equal(load_ppm(str(env / "s.ppm")),
                                  seam_overlay(img, res.visibility_map))


@pytest.mark.parametrize("argv,item", [
    (["interactive", "{inp}", "{pattern}", "--max-seams", "3"], "item 7"),
    (["ui", "{inp}", "--port", "0"], "item 7"),
    # the labels keep the test ids; every command is ported: these run
    (["carve", "{inp}", "{out}", "--seams", "-2", "--spatial"], "item 9"),
    (["carve", "{inp}", "{out}", "--seams", "-2", "--parallel", "spatial"],
     "item 9"),
])
def test_unported_commands_raise(argv, item, env, make_image, monkeypatch):
    """The commands that once raised run: `interactive` writes the files
    that the JAX CLI writes, `ui` hands the image and the device to
    `serve`, and the spatial carves equal `api.carve`."""
    inp, out = env / "in.ppm", env / "o.ppm"
    img = make_image(8, 12, c=3)
    save_ppm(str(inp), img)
    argv = [a.format(inp=inp, out=out, pattern=env / "{tag}_{{w}}.ppm")
            for a in argv]
    if argv[0] == "interactive":
        for tag, main in (("t", tmain), ("j", jmain)):
            assert main([a.format(tag=tag, w="{w}") for a in argv]) == 0
        for w in (9, 10, 12, 13, 15):  # 12 + {-3, -2, 0, 1, 3}
            got = load_ppm(str(env / f"t_{w}.ppm"))
            assert got.shape == (8, w, 3)
            np.testing.assert_array_equal(got,
                                          load_ppm(str(env / f"j_{w}.ppm")))
        assert len([f for f in os.listdir(env) if f.endswith(".ppm")]) == 11
        return
    if argv[0] == "ui":
        from dct_carver_tpu_torch import ui

        calls = []
        monkeypatch.setattr(ui, "serve", lambda image, **kw: calls.append(
            (image, kw)))
        assert tmain(argv) == 0
        (image, kw), = calls
        np.testing.assert_array_equal(image, img)
        assert kw == {"host": "127.0.0.1", "port": 0, "device": "cpu"}
        return
    assert tmain(argv) == 0
    np.testing.assert_array_equal(
        load_ppm(str(out)), tapi.carve(img, -2, device="cpu").image)


def test_i18n_opt_in_at_import():
    """`DCT_CARVER_LANG` selects the catalog when the module is imported;
    plain LANG does not (the CLI honours it, `set_language_from_env`)."""
    code = ("from dct_carver_tpu_torch.utils.i18n import _, get_language\n"
            "print(get_language(), _('Resizing width...'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = {}
    for name, extra in (("de", {"DCT_CARVER_LANG": "de"}),
                        ("lang", {"LANG": "fr_FR.UTF-8"})):
        e = {k: v for k, v in env.items() if k != "DCT_CARVER_LANG"}
        e.update(extra)
        out[name] = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=e, check=True,
            capture_output=True, text=True, timeout=120).stdout.strip()
    assert out["de"] == "de Breite wird angepasst..."
    assert out["lang"] == "en Resizing width..."


def test_i18n_catalogs_equal_jax(env, make_image, capsys, monkeypatch):
    from dct_carver_tpu.utils import i18n as ji18n

    assert i18n.available_languages() == ji18n.available_languages()
    for lang in ("de", "fr"):
        i18n.set_language(lang)
        ji18n.set_language(lang)
        try:
            for msg in ("Resizing width...", "no images found",
                        "--seams is required (or use --last-vals)"):
                assert i18n._(msg) == ji18n._(msg)
        finally:
            ji18n.set_language(None)
    i18n.set_language(None)
    monkeypatch.setenv("DCT_CARVER_LANG", "de")
    inp = env / "in.ppm"
    save_ppm(str(inp), make_image(8, 12, c=3))
    assert tmain(["carve", str(inp), str(env / "o.ppm")]) == 1
    assert i18n.get_language() == "de"
    err = capsys.readouterr().err.strip()
    assert err == i18n._("--seams is required (or use --last-vals)")
    assert err != "--seams is required (or use --last-vals)"
