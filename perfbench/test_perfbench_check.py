"""The check that decides ``correct``, driven through the rest of a run on
the CPU (the harness's look for a card skipped) at a size a test run holds:
a sound run of each cell passes under the cell's limits, and the control
(the reference in the program's place in bfloat16) and each fault planted
in the timed path (a solve that returns its state unchanged, half of the
batch left out, one answer altered where it is produced) make ``correct``
false.  On the card the same comes out at the cells' own sizes
(``perfbench/calibrate.py``; readings in ``PERF.md``).

    python -m pytest perfbench/test_perfbench_check.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import faults, run

BENCH = Path(__file__).resolve().parent
CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
KINDS = ("program", "control", *faults.FAULTS)


def small(cell: str, T: int = 12, iterations: int = 6) -> tuple[dict, dict]:
    """(overrides, the configuration they give): 64 lanes, two start
    batches, horizon T, a short budget."""
    work = run.load_json("workloads", f"{cell}.json")
    cfg = run.load_json("configs", f"{work['config']}.json")
    over = dict(horizon=T, constraint=dict(cfg["constraint"], active_ts=[T]), max_iterations=iterations)
    return dict(config=over, traffic=dict(lanes=64, pool=2)), {**cfg, **over}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_check_passes_sound_runs_and_fails_the_control_and_faults(cell, kind, monkeypatch):
    monkeypatch.setattr(run, "N_WARM", 0)
    overrides, cfg = small(cell)
    programs = {"program": None, "control": faults.control(cfg), **{k: f(cfg) for k, f in faults.FAULTS.items()}}
    program = programs[kind]
    out = run.run_cell(cell, 2**31 + 5, 0.0, False, device="cpu", overrides=overrides,
                       program=program, log=lambda *a: None)  # fmt: skip
    assert out["correct"] is (kind == "program"), out["check"]


def test_no_result_without_a_card():
    """Without CUDA the command exits with 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", str(2**31 + 1),
         "--seconds", "1", "--trace", "0"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=120,
    )  # fmt: skip
    assert proc.returncode == 2 and proc.stdout.strip() == "", proc.stderr
