"""The port's multi-process spatial carve (`dct_carver_tpu_torch/parallel/
multihost.py`, `parallel/shards.py::ProcessMesh`) in real OS processes on
the CPU, joined over gloo: the counterpart of tests/test_multiprocess.py.

Two processes of 4 CPU shards each carve one image as one 8-shard mesh;
their columns, assembled here, equal JAX's single-device `carve_n_seams`
and the port's single-controller carve on `["cpu"] * 8`, bit for bit.  Each
process writes its own checkpoint shards and resumes from them; a
single-controller checkpoint resumes on the two processes and theirs on one
controller; the liveness probe reports a healthy job, a wedged peer (with
the pending probe reused) and a killed one.  The process mesh is taken only
when asked for (`processes=True`): `api.carve` and `Carver` inside the job
carve each process's own image on one controller.  `scale` measures the cost of
a collective between processes.  `dryrun_multichip` runs on CPU meshes of
2, 4 and 8 shards against JAX.

Run as a script, this file is the worker:
    python test_torch_multiprocess.py <scenario> <rank> <nproc> <port> <dir>
It imports only torch, numpy and the port, prints markers that the tests
read, and exits with os._exit after flushing, so that a wedged or killed
peer cannot hang its exit.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SEAMS = 4      # the carve scenario: JAX's 16 x 64 image, 4 seams
CHUNK = 2
SHARDS = 4       # CPU shards a process
SCALE_SHAPE = (256, 2048)
SCALE_SEAMS = 8


def _log(*args):
    print(*args, flush=True)


def _carve_scenario(rank, nproc, workdir):
    from dct_carver_tpu_torch.parallel import multihost
    from dct_carver_tpu_torch.parallel.spatial import (
        collectives_per_seam, measure_collectives_per_seam,
        spatial_carve_n_seams, spatial_enlarge_n_seams)

    devices = ["cpu"] * SHARDS
    luma = np.load(os.path.join(workdir, "luma.npy"))
    img = np.load(os.path.join(workdir, "image.npy"))

    def save(name, x):
        np.save(os.path.join(workdir, f"{name}-{rank}.npy"), x.numpy())

    ck = os.path.join(workdir, "ck")
    res = spatial_carve_n_seams(luma, N_SEAMS, devices=devices, chunk=CHUNK,
                                checkpoint_dir=ck, image=img, processes=True)
    assert res.width == luma.shape[1] - N_SEAMS
    assert res.image_columns == res.columns
    lo, hi = res.columns
    save("vmap", res.vmap)
    save("image", res.image)
    whole = res.gather()
    save("whole", whole.vmap)
    save("whole-image", whole.image)
    _log(f"COLUMNS {lo} {hi}")

    # resume from this job's checkpoint (each process reads its shards)
    # and from the single-controller one the parent wrote
    for name in ("ck", "ck_single"):
        again = spatial_carve_n_seams(luma, N_SEAMS, devices=devices,
                                      resume_from=os.path.join(workdir,
                                                               name),
                                      image=img, processes=True)
        assert again.columns == (lo, hi) and again.width == res.width
        save(f"resumed-{name}", again.vmap)
    _log("RESUMED")

    enl = spatial_enlarge_n_seams(luma, N_SEAMS, img, devices=devices,
                                  processes=True)
    assert enl.width == luma.shape[1] + N_SEAMS
    save("enlarged", enl.image)
    _log(f"ENLARGED {enl.image_columns[0]} {enl.image_columns[1]}")

    # the exchanges of one seam step, each process counting its own (128
    # columns a shard: the dead-region window fits one, as the design
    # counts it)
    for fused in (False, True):
        m = measure_collectives_per_seam(16, 1024, devices, frontier_block=2,
                                         use_pallas=fused, processes=True)
        assert m["total"] == m["designed"] == collectives_per_seam(
            16, 2, fused_apply=fused), m
    _log("EXCHANGES_OK")

    # the public entry points keep one controller inside the job: each
    # process carves an image of its own (rank 1 the mirror image), and
    # only rank 0 calls Carver, which a collective would leave waiting
    from dct_carver_tpu_torch import api
    from dct_carver_tpu_torch.models.carver import Carver

    own = img if rank == 0 else np.ascontiguousarray(img[:, ::-1])
    got = api.carve(own, -N_SEAMS, parallel="spatial", devices=devices,
                    output_seams=True)
    np.save(os.path.join(workdir, f"api-{rank}.npy"), got.image)
    np.save(os.path.join(workdir, f"api-vmap-{rank}.npy"),
            got.visibility_map)
    if rank == 0:
        resized = Carver(own, parallel="spatial", devices=devices).resize(
            own.shape[1] - N_SEAMS, own.shape[0])
        np.save(os.path.join(workdir, "carver-0.npy"), resized.image)
    multihost.barrier("api")
    _log("API_ONE_CONTROLLER")

    h = multihost.process_health(timeout=60.0)
    assert h["healthy"] and h["processes"] == nproc, h
    _log("HEALTH_OK")
    if rank == 0:
        import threading

        # the peer is wedged (asleep): the probe cannot complete in time
        h = multihost.process_health(timeout=2.0)
        assert h["timed_out"] and not h["healthy"], h
        _log("HEALTH_TIMEOUT_OK")
        # probing again waits on the same outstanding collective
        n_thr = threading.active_count()
        h = multihost.process_health(timeout=0.5)
        assert h["timed_out"] and h["probe_pending"], h
        assert threading.active_count() == n_thr
        _log("PROBE_REUSE_OK")
        # the peer wakes and joins the pending probe; then a fresh one
        h = multihost.process_health(timeout=60.0)
        assert h["healthy"] and not h["probe_pending"], h
        _log("PROBE_RECOVERED_OK")
    else:
        time.sleep(4.0)
        for _ in range(2):  # the peer's pending probe, then its fresh one
            h = multihost.process_health(timeout=60.0)
            assert h["healthy"], h


def _scale_scenario(rank, nproc, workdir):
    import torch

    from dct_carver_tpu_torch.parallel import multihost
    from dct_carver_tpu_torch.parallel.spatial import spatial_carve_n_seams

    luma = torch.from_numpy(np.random.default_rng(0).random(
        SCALE_SHAPE, dtype=np.float32))
    # one controller holds the 8 shards; each of 2 processes holds 4
    devices = ["cpu"] * (2 * SHARDS // nproc)

    def run(n):
        t = time.perf_counter()
        spatial_carve_n_seams(luma, n, devices=devices, processes=nproc > 1)
        return time.perf_counter() - t

    n = SCALE_SEAMS
    run(n)  # the allocator's first carve
    t1, t2 = run(n), run(2 * n)
    _log(f"MARGINAL_MS_PER_SEAM {(t2 - t1) / n * 1e3!r}")
    multihost.barrier("scale-done")


def _killpeer_scenario(rank, nproc, workdir):
    from dct_carver_tpu_torch.parallel import multihost

    if rank == 0:
        # the parent SIGKILLs the peer after its READY: the probe reports
        # it, as a transport error or at the deadline, and never hangs
        time.sleep(1.0)
        h = multihost.process_health(timeout=4.0)
        assert not h["healthy"], h
        assert h["timed_out"] or h["error"], h
        _log("HEALTH_DEAD_PEER_OK")
    else:
        time.sleep(600)


def _worker(argv):
    scenario, rank, nproc, port, workdir = argv
    rank, nproc = int(rank), int(nproc)
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from dct_carver_tpu_torch.parallel import multihost

    if nproc > 1:
        multihost.initialize(f"localhost:{port}", nproc, rank,
                             backend="gloo")
        assert multihost.is_distributed()
        multihost.barrier("startup")
    _log("READY")
    {"carve": _carve_scenario, "scale": _scale_scenario,
     "killpeer": _killpeer_scenario}[scenario](rank, nproc, workdir)
    _log("DONE")


if __name__ == "__main__":
    rc = 0
    try:
        _worker(sys.argv[1:])
    except BaseException:
        import traceback

        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


# ------------------------------------------------------------ the tests ---

import re  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from dct_carver_tpu.oracle import reference as oracle  # noqa: E402
from dct_carver_tpu.ops import carve as jcarve  # noqa: E402
from dct_carver_tpu.parallel import multihost as jmultihost  # noqa: E402
from dct_carver_tpu.parallel.mesh import batch_carve_states  # noqa: E402
from dct_carver_tpu_torch import api as tapi  # noqa: E402
from dct_carver_tpu_torch.parallel import multihost  # noqa: E402
from dct_carver_tpu_torch.parallel import shards as tshards  # noqa: E402
from dct_carver_tpu_torch.parallel import spatial as tsp  # noqa: E402
from dct_carver_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip)

_SELF = os.path.abspath(__file__)
CPU8 = ["cpu"] * 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(scenario, rank, nproc, port, workdir):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, _SELF, scenario, str(rank), str(nproc), str(port),
         str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _run(scenario, nproc, workdir, timeout=300):
    port = _free_port()
    procs = [_spawn(scenario, r, nproc, port, workdir) for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} rc={rc}\nstdout:\n{out}\nstderr:\n{err}"
        assert "DONE" in out, f"rank {r}\n{out}\n{err}"
    return [out for _, out, _ in outs]


def _carve_image():
    rng = np.random.default_rng(0)  # JAX's worker's image
    img = rng.integers(0, 256, size=(16, 64, 3), dtype=np.uint8)
    return np.asarray(oracle.luma_bt709(img), np.float32), img


@pytest.fixture(scope="module")
def carve_job(tmp_path_factory):
    """The two-process carve scenario, run once: the parent writes the
    luma and a single-controller checkpoint of it, the two processes carve,
    checkpoint, resume and probe."""
    workdir = tmp_path_factory.mktemp("carve_job")
    luma, img = _carve_image()
    np.save(workdir / "luma.npy", luma)
    np.save(workdir / "image.npy", img)
    tsp.spatial_carve_n_seams(luma, N_SEAMS, devices=CPU8, chunk=CHUNK,
                              checkpoint_dir=str(workdir / "ck_single"),
                              image=img)
    outs = _run("carve", 2, workdir)
    return workdir, luma, img, outs


def _assembled(workdir, prefix):
    return np.concatenate([np.load(workdir / f"{prefix}-{r}.npy")
                           for r in range(2)], axis=1)


def _columns(outs, marker):
    return [tuple(map(int, re.search(marker + r" (\d+) (\d+)", o).groups()))
            for o in outs]


def _jax_vmap(luma):
    return jcarve.carve_n_seams(jnp.asarray(luma), N_SEAMS, 8, 0.0, 1.0,
                                strip_update=False).vmap


def test_two_process_columns_equal_jax_and_one_controller(carve_job):
    workdir, luma, img, outs = carve_job
    assert _columns(outs, "COLUMNS") == [(0, 32), (32, 64)]
    got = _assembled(workdir, "vmap")
    np.testing.assert_array_equal(got, np.asarray(_jax_vmap(luma)))
    one = tsp.spatial_carve_n_seams(luma, N_SEAMS, devices=CPU8, image=img)
    np.testing.assert_array_equal(got, one.vmap.numpy())
    image = _assembled(workdir, "image")
    np.testing.assert_array_equal(image, one.image.numpy())
    for r in range(2):  # gather(): the whole planes on every process
        np.testing.assert_array_equal(np.load(workdir / f"whole-{r}.npy"),
                                      got)
        np.testing.assert_array_equal(
            np.load(workdir / f"whole-image-{r}.npy"), image)


def test_two_process_enlargement_equals_jax(carve_job):
    workdir, luma, img, outs = carve_job
    # 68 output columns over 8 shards of 9: 36 on the first process
    assert _columns(outs, "ENLARGED") == [(0, 36), (36, 68)]
    want = jcarve.reconstruct_enlarged(jnp.asarray(img), _jax_vmap(luma),
                                       N_SEAMS)
    np.testing.assert_array_equal(_assembled(workdir, "enlarged"),
                                  np.asarray(want))


def test_each_process_writes_its_own_shards(carve_job):
    workdir, _, _, _ = carve_job
    ck = workdir / "ck"
    assert sorted(os.listdir(ck)) == ["meta.json", "state-00000002"]
    step = ck / "state-00000002"
    for r in range(2):
        with open(step / f"process-{r:05d}.json") as f:
            manifest = json.load(f)
        assert manifest == {"process": r, "shards": [
            f"shard-{s:05d}.npz" for s in range(4 * r, 4 * r + 4)]}
    with open(ck / "meta.json") as f:
        meta = json.load(f)
    assert meta["shards"] == 8 and meta["buffer_width"] == 64
    assert sorted(p.name for p in step.glob("shard-*.npz")) == [
        f"shard-{s:05d}.npz" for s in range(8)]


def test_two_process_resume_equals_uninterrupted(carve_job):
    workdir, _, _, outs = carve_job
    assert all("RESUMED" in o for o in outs)
    np.testing.assert_array_equal(_assembled(workdir, "resumed-ck"),
                                  _assembled(workdir, "vmap"))


def test_one_controller_checkpoint_resumes_on_two_processes(carve_job):
    workdir, _, _, _ = carve_job
    np.testing.assert_array_equal(_assembled(workdir, "resumed-ck_single"),
                                  _assembled(workdir, "vmap"))


@pytest.mark.parametrize("devices", [CPU8, ["cpu"] * 4, ["cpu"] * 2],
                         ids=["8-shards", "4-shards", "2-shards"])
def test_two_process_checkpoint_resumes_on_one_controller(carve_job,
                                                          devices):
    workdir, luma, img, _ = carve_job
    res = tsp.spatial_carve_n_seams(luma, N_SEAMS, devices=devices,
                                    resume_from=str(workdir / "ck"),
                                    image=img)
    assert res.columns == (0, 64) and res.gather() is res
    np.testing.assert_array_equal(res.vmap.numpy(),
                                  _assembled(workdir, "vmap"))


def test_public_entry_points_keep_one_controller_in_a_job(carve_job):
    """Inside a job `api.carve` / `Carver` on the spatial route carve the
    process's own image on one controller, whole, as outside it."""
    workdir, _, img, outs = carve_job
    assert all("API_ONE_CONTROLLER" in o for o in outs)
    for r, own in enumerate((img, img[:, ::-1])):
        want = tapi.carve(own, -N_SEAMS, device="cpu", output_seams=True)
        np.testing.assert_array_equal(np.load(workdir / f"api-{r}.npy"),
                                      want.image)
        np.testing.assert_array_equal(
            np.load(workdir / f"api-vmap-{r}.npy"), want.visibility_map)
    np.testing.assert_array_equal(np.load(workdir / "carver-0.npy"),
                                  tapi.carve(img, -N_SEAMS,
                                             device="cpu").image)


def test_exchanges_a_seam_equal_design_on_each_process(carve_job):
    _, _, _, outs = carve_job
    assert all("EXCHANGES_OK" in o for o in outs)


def test_probe_healthy_then_wedged_peer_times_out(carve_job):
    _, _, _, outs = carve_job
    assert all("HEALTH_OK" in o for o in outs)
    for marker in ("HEALTH_TIMEOUT_OK", "PROBE_REUSE_OK",
                   "PROBE_RECOVERED_OK"):
        assert marker in outs[0], outs[0]


def test_two_process_killed_peer_detected(tmp_path):
    """SIGKILL one process after startup; the survivor's liveness probe
    reports it unhealthy within its deadline instead of hanging."""
    port = _free_port()
    p0 = _spawn("killpeer", 0, 2, port, tmp_path)
    p1 = _spawn("killpeer", 1, 2, port, tmp_path)
    try:
        lines = []
        ready = threading.Event()

        def reader():
            for line in p1.stdout:
                lines.append(line)
                if "READY" in line:
                    ready.set()

        threading.Thread(target=reader, daemon=True).start()
        assert ready.wait(120), f"rank 1 never reached READY: {lines}"
        p1.send_signal(signal.SIGKILL)
        t = time.monotonic()
        out, err = p0.communicate(timeout=120)
        assert p0.returncode == 0, f"rc={p0.returncode}\n{out}\n{err}"
        assert "HEALTH_DEAD_PEER_OK" in out, f"{out}\n{err}"
        assert time.monotonic() - t < 60
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()


def test_two_process_scaling_overhead(tmp_path):
    """The same spatial carve at the same total shard count, on one
    controller (1 process x 8 shards) and on two (2 x 4, the collectives
    over gloo's local TCP): the difference a seam over the exchanges a seam
    is the cost of one collective between processes, which must be in a
    plausible TCP range.  Each runs one thread, as the JAX test's devices
    do; the runs are sequential."""
    def marginal(out):
        return float(re.search(r"MARGINAL_MS_PER_SEAM (-?[\d.e-]+)",
                               out).group(1))

    ms1 = marginal(_run("scale", 1, tmp_path)[0])
    ms2 = marginal(_run("scale", 2, tmp_path)[0])
    if ms1 <= 0 or ms2 <= 0:
        pytest.skip(f"host too loaded for differential timing "
                    f"(ms1={ms1}, ms2={ms2})")
    n_coll = tsp.collectives_per_seam(SCALE_SHAPE[0], fused_apply=True)
    per_coll_ms = (ms2 - ms1) / n_coll
    print(f"one controller {ms1:.2f} ms/seam, 2 processes {ms2:.2f} ms/seam "
          f"over {n_coll} collectives/seam -> {per_coll_ms * 1e3:.0f} "
          f"us/collective over gloo")
    assert per_coll_ms < 60.0, (ms1, ms2, per_coll_ms)


# ------------------------------------------------------ in one process ---

def test_single_process_no_ops(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is None
    assert not multihost.is_distributed()
    assert multihost.barrier("startup") is None
    assert multihost.process_health(timeout=1.0) \
        == jmultihost.process_health(timeout=1.0)
    # one controller's mesh: no collective, no barrier, rank 0
    assert tshards.shard_count(["cpu"] * 3) == 3
    mesh = tshards.shard_mesh(["cpu"] * 2, 8)
    assert type(mesh) is tshards.ShardMesh and mesh.rank == 0
    assert mesh.barrier() is None


def test_process_mesh_without_a_job_raises():
    """A process mesh is asked for, never inferred: with no job it
    raises."""
    assert not multihost.is_distributed()
    luma = np.random.default_rng(0).random((16, 64), dtype=np.float32)
    for call in (lambda: tshards.shard_mesh(["cpu"] * 2, 8, processes=True),
                 lambda: tshards.shard_count(["cpu"] * 2, processes=True),
                 lambda: tsp.spatial_carve_n_seams(
                     luma, 2, devices=["cpu"] * 2, processes=True)):
        with pytest.raises(RuntimeError, match="processes=True"):
            call()


def test_initialize_without_card_or_backend_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multihost.initialize("localhost:1", 2, 0)
    assert not multihost.is_distributed()


def test_generalized_dp_steps_are_never_captured():
    """The spatial step captures a CUDA graph only with the kernels' DP:
    the plain scan of delta_x/rigidity other than (1, 0) allocates under
    capture (found by dryrun_multichip's generalized-DP case on a card)."""
    assert tsp._kernel_dp(tsp._params(64, 16))
    for kw in (dict(delta_x=2), dict(rigidity=0.5), dict(use_pallas=False)):
        assert not tsp._kernel_dp(tsp._params(64, 16, **kw))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_equals_jax(n):
    out = dryrun_multichip(n, devices=["cpu"] * n)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(2 * n, 32, 40, 3), dtype=np.uint8)
    states = batch_carve_states(jnp.asarray(images), 2, 8, 0.0, 1.0, True)
    np.testing.assert_array_equal(out["batch_vmap"],
                                  np.asarray(states.vmap))
    want = np.stack([np.asarray(jcarve.reconstruct_removed(
        jnp.asarray(im), vm, 2)) for im, vm in zip(images, states.vmap)])
    np.testing.assert_array_equal(out["batch_image"], want)

    img = rng.integers(0, 256, size=(24, 8 * n, 3), dtype=np.uint8)
    luma = jnp.asarray(out["luma"])
    ref = jcarve.carve_n_seams(luma, 2, 8, 0.0, 1.0, strip_update=False)
    np.testing.assert_array_equal(out["spatial_vmap"], np.asarray(ref.vmap))
    np.testing.assert_array_equal(out["spatial_image"], np.asarray(
        jcarve.reconstruct_removed(jnp.asarray(img), ref.vmap, 2)))
    np.testing.assert_array_equal(out["enlarged_image"], np.asarray(
        jcarve.reconstruct_enlarged(jnp.asarray(img), ref.vmap, 2)))
    ref_d = jcarve.carve_n_seams(luma, 2, 8, 0.0, 1.0, strip_update=False,
                                 delta_x=2, rigidity=0.5)
    np.testing.assert_array_equal(out["delta_vmap"], np.asarray(ref_d.vmap))
