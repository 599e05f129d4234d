"""On the card: one short run of the headline cell through run.py's own
entry, a result line, `correct` true.  Skipped where no card is visible;
on the chip: python3 -m pytest benchmark/tests -m card."""

import json
import subprocess
import sys

import pytest

from benchlib.spec import BENCH, ROOT


@pytest.mark.card
def test_headline_runs_on_the_card(card):
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "photo1080_n8.headline", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["metrics"]["mpix_s"]["value"] > 0
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
