"""Multi-process initialization and failure detection over
`torch.distributed`.

Counterpart of `dct_carver_tpu/parallel/multihost.py` (`initialize`,
`is_distributed`, `barrier`, `process_health`): the port's processes join
one job through a TCP rendezvous, and `parallel/shards.py::ProcessMesh`
spreads one image's column shards over them.  With
`utils/checkpoint.py::save_sharded` (each process writes its own shards)
the seam loop is restartable after a process fails.

Backends follow the port's device rule: NCCL, one card a process, unless
the caller asks for gloo (CPU processes, or several processes sharing one
card, which NCCL refuses).  Nothing switches backend after a failure.
Besides the job's default group, `initialize` makes one gloo group of CPU
tensors for the liveness probe, so a probe works under NCCL too and never
interleaves with the carve's collectives; `failed_processes`, the
processes' agreement on a step that each prepared alone (a CUDA graph
capture), runs on it too.

With one process everything degrades to no-ops, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
import time

import torch
import torch.distributed as dist

from ..utils.placement import NO_CARD

__all__ = ["initialize", "is_distributed", "barrier", "process_health",
           "failed_processes"]

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

_initialized = False
_probe_group = None  # the gloo group of the liveness probe
_probe = None        # (thread, outcome): at most ONE outstanding probe


def _local_card(rank: int) -> int:
    """The card of process `rank` under NCCL: LOCAL_RANK when a launcher
    sets it, else the rank modulo the visible cards."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else \
        rank % torch.cuda.device_count()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join the job: `coordinator_address` "host:port" (process 0 listens
    there) with `num_processes` and `process_id`, or torchrun's variables
    (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK).  A no-op with neither
    (one process), or when already initialized.

    `backend`: "nccl" by default, which sets this process's card
    (LOCAL_RANK, else the rank modulo the visible cards); "gloo" for CPU
    processes or processes sharing a card.  Raises when no card is visible
    and no backend is named: the port runs on the card unless the caller
    asks for the CPU."""
    global _initialized, _probe_group
    if _initialized:
        return
    if coordinator_address is None and not all(
            v in os.environ for v in _TORCHRUN_VARS):
        return  # single-process mode
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{NO_CARD}; with several processes, pass "
                               "backend='gloo'")
        backend = "nccl"
    kw = {}
    if coordinator_address is not None:
        addr = coordinator_address
        kw = dict(init_method=addr if "://" in addr else f"tcp://{addr}",
                  world_size=int(num_processes),
                  rank=int(process_id or 0))
    if backend == "nccl":
        rank = kw.get("rank", int(os.environ.get("RANK", "0")))
        torch.cuda.set_device(_local_card(rank))
    dist.init_process_group(backend=backend, **kw)
    _probe_group = dist.new_group(backend="gloo")
    _initialized = True


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def barrier(name: str = "startup") -> None:
    """Cross-process barrier on the default group.  Hangs (then raises at
    the group's timeout) if a process is down.  `name` labels the call, as
    the JAX package's does."""
    del name
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def failed_processes(ok: bool) -> list[int]:
    """The ranks of the processes that call this with `ok` false: a
    collective that every process makes, one int32 a process all-gathered
    on the probe's gloo group, so the NCCL communicator takes no part.
    With one process, [0] or []."""
    if not is_distributed():
        return [] if ok else [0]
    if _probe_group is None:
        raise RuntimeError("failed_processes needs multihost.initialize: it "
                           "runs on the gloo group that initialize makes")
    out = [torch.zeros(1, dtype=torch.int32)
           for _ in range(dist.get_world_size())]
    dist.all_gather(out, torch.tensor([int(ok)], dtype=torch.int32),
                    group=_probe_group)
    return [r for r, x in enumerate(out) if not x.item()]


def process_health(timeout: float = 30.0) -> dict:
    """Timeout-based liveness probe.

    A collective over live processes can only complete, fail, or hang; the
    observable health signal is whether it completes within a deadline.
    The allgather (one int32 a process, on the probe's own gloo group) runs
    in a worker thread: completion within `timeout` = healthy; a raised
    transport error = unhealthy with the error surfaced (`error`); no
    result within the deadline = unhealthy with `timed_out`.

    A timed-out probe's collective cannot be cancelled, so its thread stays
    blocked until the peer joins it or gloo's timeout gives up.  At most
    ONE such thread ever exists: repeated probes of a wedged job wait on
    the outstanding collective instead of stacking new threads
    (`probe_pending` reports that state); a recovered peer unwedges it,
    after which fresh probes run again.
    """
    global _probe
    if not is_distributed():
        return {"processes": 1, "healthy": True, "timed_out": False,
                "probe_pending": False, "error": None}

    def report(t, outcome):
        global _probe
        pending = t.is_alive()
        _probe = (t, outcome) if pending else None
        return {
            "processes": dist.get_world_size(),
            "healthy": (not pending) and outcome.get("ok", False),
            "timed_out": pending,
            "probe_pending": pending,
            "error": outcome.get("error"),
        }

    if _probe is not None:
        # the previous probe is still blocked in its collective: wait on IT
        t, outcome = _probe
        t_wait = time.monotonic()
        t.join(timeout)
        if t.is_alive():
            return report(t, outcome)
        _probe = None  # consumed; fall through to a fresh probe
        # the fresh probe gets only the REMAINING budget, so the total wait
        # never exceeds ~`timeout`
        timeout = max(0.0, timeout - (time.monotonic() - t_wait))

    outcome = {}
    group = _probe_group
    if group is None:
        raise RuntimeError("process_health needs multihost.initialize: the "
                           "probe runs on the gloo group it makes")

    def run():
        try:
            out = [torch.zeros(1, dtype=torch.int32)
                   for _ in range(dist.get_world_size())]
            dist.all_gather(out, torch.ones(1, dtype=torch.int32),
                            group=group)
            outcome["ok"] = True
        except Exception as e:  # transport failure = peer down
            outcome["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    return report(t, outcome)
