"""On the card only (marker ``chip``): one short run of a cell through the
command the benchmark is run by, its last line parsed as JSON."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["jamba52b.decode-chat8",
                                  "jamba52b.prefill-mix8k"])
def test_a_short_run_on_the_card(card, cell):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                        "--seed", "2147483901", "--seconds", "3", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], r.stderr[-3000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"]
