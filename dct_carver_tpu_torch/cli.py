"""Command-line interface of the port — the non-interactive run mode of the
plugin (`src/main.c:146-160`: 12 PDB params -> PlugInVals), plus the
energy and seam exports (`src/render.c:370-385`) and a batch mode.

Counterpart of `dct_carver_tpu/cli.py`, with the same parser and one more
option, `--device` (default `cuda`: the first card; the kernels build at
first use into `build/dct_carver_tpu_torch/`, the analog of the JAX
package's compilation cache).  It is the counterpart of the JAX CLI running
wherever `JAX_PLATFORMS` points: with no card visible the CLI raises unless
`--device cpu` asks for the CPU.  `--spatial` / `--parallel spatial`
column-shard the image over every visible card (`parallel/spatial.py`), or
over one CPU shard with `--device cpu`; `batch` splits its images over
every visible card the same way (`parallel/mesh.py::carve_batch`), or
over the one device that `--device cuda:k` / `cpu` names.

Usage examples:
    python -m dct_carver_tpu_torch.cli carve in.png out.png --seams -64
    python -m dct_carver_tpu_torch.cli carve in.ppm out.ppm --seams -64 \\
        --energy grad_norm --checkpoint ck.npz --checkpoint-every 16
    python -m dct_carver_tpu_torch.cli energy in.png energy.png --blocksize 16
    python -m dct_carver_tpu_torch.cli batch in_dir/ out_dir/ --seams 32
    python -m dct_carver_tpu_torch.cli carve pano.png out.png --seams -64 \\
        --parallel spatial
    python -m dct_carver_tpu_torch.cli interactive in.png out_{w}.png \\
        --max-seams 64
    python -m dct_carver_tpu_torch.cli ui in.png --port 8707
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .utils.i18n import _ as _t, set_language_from_env


def _add_knobs(p: argparse.ArgumentParser) -> None:
    # the reference's knobs, defaults per src/main.c:30-40
    p.add_argument("--blocksize", type=int, default=8, choices=[2, 4, 8, 16])
    p.add_argument("--edges", type=float, default=0.0)
    p.add_argument("--textures", type=float, default=1.0)
    p.add_argument("--vertically", action="store_true",
                   help="retarget height instead of width")
    p.add_argument("--luma", default="bt709", choices=["bt709", "bt601_studio"])
    p.add_argument("--delta-x", type=int, default=1, dest="delta_x",
                   help="max seam step per row (liblqr lqr_carver_init)")
    p.add_argument("--rigidity", type=float, default=0.0,
                   help="seam step penalty: rigidity * |dx| / delta_x")
    p.add_argument("--tie", default="leftmost",
                   choices=["leftmost", "rightmost"],
                   help="DP tie rule (S1/S2 spec knob, docs/PARITY.md)")
    p.add_argument("--no-strip-update", action="store_true",
                   help="full energy recompute per seam")
    p.add_argument("--energy", default="dct",
                   choices=["dct", "grad_xabs", "grad_sumabs", "grad_norm"],
                   help="energy function (lqr_carver_set_energy_function "
                        "analog); 'dct' = the reference's DCT energy")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the first CUDA "
                        "card, and every visible card for the spatial "
                        "route and batch; 'cpu' runs on the CPU)")


def _run_batch(args) -> int:
    """Config-4 style batch carve: every image in a directory, one launch
    per kernel and seam for the whole stack (parallel/mesh.py)."""
    import os

    import numpy as np

    from .utils.placement import default_mesh, resolve_device
    from .parallel.mesh import carve_batch
    from .utils.image import load_image, save_image

    names = sorted(
        f for f in os.listdir(args.input_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".ppm", ".pgm", ".npy"))
    )
    if not names:
        print(_t("no images found"), file=sys.stderr)
        return 1
    imgs = [load_image(os.path.join(args.input_dir, f)) for f in names]
    shape = imgs[0].shape
    if any(i.shape != shape for i in imgs):
        print(_t("batch mode requires identically-sized images"), file=sys.stderr)
        return 1
    if args.vertically:
        imgs = [np.swapaxes(i, 0, 1) for i in imgs]

    t0 = time.perf_counter()
    out, _ = carve_batch(
        np.stack(imgs), args.seams,
        blocksize=args.blocksize, edges=args.edges, textures=args.textures,
        strip_update=not args.no_strip_update, energy=args.energy,
        luma=args.luma, delta_x=args.delta_x, rigidity=args.rigidity,
        tie=args.tie, devices=default_mesh(resolve_device(args.device)),
    )
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    os.makedirs(args.output_dir, exist_ok=True)
    for f, o in zip(names, out):
        if args.vertically:
            o = np.swapaxes(o, 0, 1)
        save_image(os.path.join(args.output_dir, f), o)
    h, w = shape[:2]
    print(json.dumps({
        "images": len(names), "seams": args.seams, "seconds": round(dt, 3),
        "mpix_per_s": round(len(names) * h * w * args.seams / dt / 1e6, 2),
    }), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dct-carver-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("carve", help="seam-carve retargeting")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--seams", type=int, default=None,
                   help="signed seam count: <0 remove, >0 insert")
    c.add_argument("--output-energy", metavar="PATH", default=None)
    c.add_argument("--output-seams", metavar="PATH", default=None)
    c.add_argument("--last-vals", action="store_true",
                   help="rerun with the previously saved settings "
                        "(GIMP_RUN_WITH_LAST_VALS, src/main.c:193-205)")
    c.add_argument("--progress", action="store_true",
                   help="per-chunk progress on stderr (liblqr progress hooks)")
    c.add_argument("--checkpoint", metavar="PATH", default=None,
                   help="snapshot carver state here every --checkpoint-every "
                        "seams (resume with --resume)")
    c.add_argument("--checkpoint-every", type=int, default=32)
    c.add_argument("--resume", metavar="PATH", default=None,
                   help="resume an interrupted carve from a checkpoint")
    c.add_argument("--no-resize-canvas", action="store_true",
                   help="keep the original canvas size (resize_canvas=FALSE "
                        "analog, src/main.h:19): removals zero-fill the "
                        "vacated region, enlargements crop")
    c.add_argument("--spatial", action="store_true",
                   help="column-shard the image over the devices "
                        "(parallel/spatial.py)")
    c.add_argument("--parallel", default=None,
                   choices=["none", "spatial", "auto"],
                   help="execution route (overrides --spatial)")
    _add_knobs(c)

    it = sub.add_parser("interactive",
                        help="precompute-once / slide-many retargeting")
    it.add_argument("input")
    it.add_argument("output_pattern",
                    help="output path with a {w} placeholder, e.g. out_{w}.png")
    it.add_argument("--max-seams", type=int, required=True)
    it.add_argument("--widths", type=int, nargs="+", default=None,
                    help="explicit target widths (default: 5 evenly spaced)")
    _add_knobs(it)

    e = sub.add_parser("energy", help="export the normalized energy image")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--preview", action="store_true",
                   help="use the GUI-preview energy path (BT.601 luma + "
                        "preview window centering, src/render.c:421)")
    _add_knobs(e)

    b = sub.add_parser("batch", help="carve a directory of same-sized images "
                                     "as one stack")
    b.add_argument("input_dir")
    b.add_argument("output_dir")
    b.add_argument("--seams", type=int, required=True,
                   help="seams to REMOVE from each image (positive count)")
    _add_knobs(b)

    u = sub.add_parser("ui", help="interactive browser UI")
    u.add_argument("input")
    u.add_argument("--host", default="127.0.0.1")
    u.add_argument("--port", type=int, default=8707)
    u.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the first CUDA "
                        "card; 'cpu' runs on the CPU)")

    args = ap.parse_args(argv)

    # the CLI (unlike library imports) honors the process locale (LANG)
    set_language_from_env()

    from .utils.image import load_image, save_image, seam_overlay

    if args.cmd == "batch":
        return _run_batch(args)

    img = load_image(args.input)

    if args.cmd == "ui":
        from .ui import serve

        serve(img, host=args.host, port=args.port, device=args.device)
        return 0

    if args.cmd == "interactive":
        from .models.retarget import InteractiveRetargeter

        rt = InteractiveRetargeter(
            img, args.max_seams, blocksize=args.blocksize, edges=args.edges,
            textures=args.textures, luma=args.luma, delta_x=args.delta_x,
            rigidity=args.rigidity, vertical=args.vertically,
            strip_update=not args.no_strip_update, tie=args.tie,
            energy=args.energy, device=args.device,
        )
        dim = img.shape[0] if args.vertically else img.shape[1]
        widths = args.widths or [
            dim + d for d in sorted({
                -args.max_seams, -args.max_seams // 2, 0,
                args.max_seams // 2, args.max_seams,
            })
        ]
        for w in widths:
            out = rt.at_width(w)
            path = args.output_pattern.format(w=w)
            save_image(path, out)
            print(f"{path}: {out.shape[1]}x{out.shape[0]}", file=sys.stderr)
        return 0

    if args.cmd == "energy":
        from .models.carver import Carver
        from .utils.config import CarverConfig

        cfg = CarverConfig(
            blocksize=args.blocksize, edges=args.edges, textures=args.textures,
            vertically=args.vertically, luma=args.luma, energy=args.energy,
        )
        carver = Carver(img, cfg, device=args.device)
        out = carver.energy_preview() if args.preview else carver.energy_image()
        save_image(args.output, out)
        return 0

    from .utils.settings import load_last_vals, save_last_vals

    knobs = dict(
        seams_number=args.seams, blocksize=args.blocksize, edges=args.edges,
        textures=args.textures, vertically=args.vertically, luma=args.luma,
        delta_x=args.delta_x, rigidity=args.rigidity, energy=args.energy,
        tie=args.tie,
    )
    if args.last_vals:
        stored = load_last_vals()
        if not stored:
            print(_t("no saved settings; run once without --last-vals first"),
                  file=sys.stderr)
            return 1
        knobs.update({k: v for k, v in stored.items() if k in knobs})
    if knobs["seams_number"] is None:
        print(_t("--seams is required (or use --last-vals)"), file=sys.stderr)
        return 1

    from .models.carver import Carver
    from .utils.config import CarverConfig
    from .utils.progress import StderrProgress

    cfg = CarverConfig(
        output_energy=args.output_energy is not None,
        output_seams=args.output_seams is not None,
        strip_update=not args.no_strip_update,
        resize_canvas=not args.no_resize_canvas,
        parallel=(args.parallel or ("spatial" if args.spatial else "none")),
        **knobs,
    )
    carver = Carver(
        img, cfg, device=args.device,
        progress=StderrProgress() if args.progress else None,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume,
    )
    h0, w0 = img.shape[:2]
    s0 = cfg.seams_number
    t0 = time.perf_counter()
    if s0 == 0:
        # every knob goes through, the energy and the axis included (the
        # JAX CLI drops them here: ROADMAP Queue 3)
        from .api import carve as _carve_api

        res = _carve_api(img, 0, blocksize=cfg.blocksize, edges=cfg.edges,
                         textures=cfg.textures, vertically=cfg.vertically,
                         output_energy=cfg.output_energy,
                         output_seams=cfg.output_seams, luma=cfg.luma,
                         energy=cfg.energy, tie=cfg.tie,
                         device=args.device)
    elif cfg.vertically:
        res = carver.resize(w0, h0 + s0)
    else:
        res = carver.resize(w0 + s0, h0)
    dt = time.perf_counter() - t0
    save_last_vals(knobs)
    save_image(args.output, res.image)
    if args.output_energy:
        save_image(args.output_energy, res.energy_image)
    if args.output_seams:
        save_image(args.output_seams, seam_overlay(img, res.visibility_map))
    h, w = img.shape[:2]
    print(json.dumps({
        "input": list(img.shape), "output": list(res.image.shape),
        "seams": s0, "seconds": round(dt, 3),
        "mpix_per_s": round(h * w * abs(s0) / dt / 1e6, 2),
    }), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
