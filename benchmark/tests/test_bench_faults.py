"""The harness's run, with no look for a card, over the program's CPU
path at a small size: sound, `correct` comes out true; with the timed path
broken underneath in each way a cell can break, false.

Faults: a seam step that leaves its state unchanged; an answer altered
where it is produced (one value of every carved image); and, on the batch
route over several devices, half of each chunk's images left uncarved,
and the exchange between devices left out (every chunk's result but the
first replaced by the first's in the join)."""

import dataclasses

import numpy as np
import pytest
import torch

import run
from benchlib import spec

SMALL = {
    "photo1080_n8.headline": ({"height": 24, "width": 40},
                              {"remove": {"width": 3}}, {"device": "cpu"}, 1),
    "uhd4k_n16.bidir": ({"height": 40, "width": 48}, {}, {"device": "cpu"}, 1),
    "batch1m_n8_x4.b1024": ({"height": 24, "width": 32},
                            {"batch": 8, "remove": {"width": 3}},
                            {"devices": ["cpu"] * 4}, 4),
}


def _run(name):
    cfg, traffic, placement, cards = SMALL[name]
    cell = spec.load_cell(name)
    cell = dataclasses.replace(cell, config={**cell.config, **cfg},
                               traffic={**cell.traffic, **traffic})
    result, lines = run.run(cell, 2**31 + 3, 0.05, False, device="cpu",
                            placement=placement, cards=cards)
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks" and len(lines) == len(
        result["checks"])
    return result


def _unchanged_step(monkeypatch):
    from dct_carver_tpu_torch.ops import carve

    def step(self, src):  # the state stays as it was; the counters move
        for o, x in zip(self.sets[1 - src], self.sets[src]):
            o.copy_(x)
        self.ctr.add_(self.step_delta)

    monkeypatch.setattr(carve.SeamSteps, "_step", step)


def _altered_answer(monkeypatch):
    from dct_carver_tpu_torch.ops import carve

    orig = carve.reconstruct_removed

    def altered(image, vmap, n):
        out = orig(image, vmap, n).clone()
        out[..., 0, 1, 0] ^= 1  # a value no later pass flips back
        return out

    monkeypatch.setattr(carve, "reconstruct_removed", altered)


def _half_batch(monkeypatch):
    from dct_carver_tpu_torch.ops import carve
    from dct_carver_tpu_torch.parallel import mesh

    orig = mesh._carve_chunk

    def half(chunk, dev, n_seams, reconstruct, **knobs):
        k = (len(chunk) + 1) // 2
        vmap, out = orig(chunk[:k], dev, n_seams, reconstruct, **knobs)
        rest = chunk[k:].to(dev)
        vmap = torch.cat([vmap, torch.zeros(rest.shape[:3], dtype=vmap.dtype,
                                            device=vmap.device)])
        if out is not None:
            out = torch.cat([out, rest[:, :, :rest.shape[2] - n_seams]])
        return vmap, out

    monkeypatch.setattr(mesh, "_carve_chunk", half)
    assert carve  # the route's own reconstruct stays


def _no_exchange(monkeypatch):
    from dct_carver_tpu_torch.parallel import mesh

    def join(parts, home):
        return torch.cat([parts[0].to(home)] * len(parts))

    monkeypatch.setattr(mesh, "_join", join)


FAULTS = {"unchanged_step": _unchanged_step,
          "altered_answer": _altered_answer,
          "half_batch": _half_batch, "no_exchange": _no_exchange}
CASES = [(c, None) for c in SMALL] + [
    (c, f) for c in SMALL for f in ("unchanged_step", "altered_answer")] + [
    ("batch1m_n8_x4.b1024", "half_batch"),
    ("batch1m_n8_x4.b1024", "no_exchange")]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_correct_sees_the_fault(monkeypatch, name, fault):
    if fault:
        FAULTS[fault](monkeypatch)
    result = _run(name)
    assert result["correct"] is (fault is None), result["checks"]
    if fault:
        assert any(v["value"] > v["limit"]
                   for v in result["checks"].values())
    timed = [m["name"] for m in spec.load_cell(name).end_to_end
             if m["name"] not in ("setup_s", "peak_mib_per_image")]
    assert timed and all(np.isfinite(result["metrics"][n]["value"])
                         for n in timed)
