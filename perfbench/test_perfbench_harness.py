"""The harness on the CPU: every cell of ``BENCHMARK.json`` builds and runs
one tiny call through the port's plain version; a configuration, a traffic
generator and mix, an entry point, a cell and a per-layer metric dropped
into a copy as new files are found without an edit to any file there; and
no run loads a module whose top-level name is JAX's or the JAX package's.

    python -m pytest perfbench/test_perfbench_harness.py -q
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "ddp_tpu"}

# one run of a cell in a fresh interpreter, from the checkout at argv[1]
ONE_RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
from perfbench import run
out = run.run_cell(sys.argv[2], 2**31 + 11, 0.0, bool(int(sys.argv[3])), device="cpu",
                   overrides=json.loads(sys.argv[4]), log=lambda *a: None)
print(json.dumps(dict(out=out, modules=sorted({m.split(".")[0] for m in sys.modules}))))
"""


def tiny(root: Path, cell: str, T: int = 8) -> dict:
    """Overrides that shrink a cell to 8 lanes, two start batches, horizon T
    and two iterations."""
    work = json.loads((root / "perfbench" / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((root / "perfbench" / "configs" / f"{work['config']}.json").read_text())
    con = dict(cfg["constraint"], active_ts=[T])
    return dict(config=dict(horizon=T, constraint=con, max_iterations=2), traffic=dict(lanes=8, pool=2))


def drive(root: Path, cell: str, trace: bool) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", ONE_RUN, str(root), cell, str(int(trace)), json.dumps(tiny(root, cell))],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def e2e_names(cell):
    return {m["name"] for m in MANIFEST["end_to_end"] if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_one_tiny_call_on_the_cpu(cell):
    """The cell's whole run (set-up, window, check, metrics) at a tiny size;
    the port and the benchmark load no JAX (names compared whole, so
    ``ddp_tpu_torch`` passes)."""
    res = drive(ROOT, cell, trace=False)
    out = res["out"]
    assert out["attempted"] >= 8 and out["failed"] == 0
    assert set(out["metrics"]) == e2e_names(cell)
    assert list(out)[-1] == "check" and set(out["check"]) >= {"lanes_apart", "rollout_residual"}
    assert "ddp_tpu_torch" in res["modules"]
    assert not FORBIDDEN & set(res["modules"])


# a traced run whose profiler stops after the window's first call
TRACED_HEAD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from perfbench import run
run.TRACE_SECONDS = 0.0
reduce = run.reduce_trace
traced = []
run.reduce_trace = lambda path: traced.append(reduce(path)) or traced[-1]
lines = []
out = run.run_cell(sys.argv[2], 2**31 + 11, 1.0, True, device="cpu", overrides=json.loads(sys.argv[3]), log=lines.append)
window = next(line for line in lines if line.startswith("[window]"))
print(json.dumps(dict(out=out, traced_calls=len(traced[0]["calls"]), calls=int(window.split()[1].split("=")[1]))))
"""


def test_traced_run_records_the_head_of_the_window():
    """The profiler records the window's first ``TRACE_SECONDS`` and the
    window runs on untraced to ``--seconds``; the readers see only the
    traced calls."""
    cell = CELLS[0]
    proc = subprocess.run(
        [sys.executable, "-c", TRACED_HEAD, str(ROOT), cell, json.dumps(tiny(ROOT, cell))],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["traced_calls"] == 1 < res["calls"]
    assert res["out"]["correct"] and res["out"]["device"]["window_s"] > 0


def test_reference_imports_nothing_of_the_program():
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "import perfbench.reference.compare, perfbench.reference.flat_al_ddp, perfbench.counts.flat_solve;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods = set(json.loads(proc.stdout))
    assert not (FORBIDDEN | {"ddp_tpu_torch"}) & mods


def _digest(root: Path) -> dict:
    return {
        str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
    }


def test_new_files_are_found_without_edits(tmp_path):
    """Into a copy of the benchmark drop a configuration, a traffic
    generator and a mix of it, an entry point, a cell and a per-layer metric
    as new files (and their entries in the copy's manifest, the metric's
    without a ``workloads`` key); the harness runs the new cell through
    them, reports the new metric in its traced run, and no file that was
    there before changes."""
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "ddp_tpu_torch").symlink_to(ROOT / "ddp_tpu_torch", target_is_directory=True)
    before = _digest(tmp_path / "perfbench")
    new = tmp_path / "perfbench"
    cfg = json.loads((new / "configs" / "pendulum_swingup_t32.json").read_text())
    cfg.update(name="extra_pendulum", horizon=12, constraint=dict(cfg["constraint"], active_ts=[12]))
    (new / "configs" / "extra_pendulum.json").write_text(json.dumps(cfg))
    mix = json.loads((new / "traffic" / "closed_loop.b4096.json").read_text())
    (new / "traffic" / "one_client.py").write_text((new / "traffic" / "closed_loop.py").read_text())
    (new / "traffic" / "one_client.b8.json").write_text(json.dumps(dict(mix, kind="one_client", lanes=8)))
    (new / "routes" / "solve_flat_again.py").write_text((new / "routes" / "solve_flat.py").read_text())
    cell = dict(config="extra_pendulum", traffic="one_client.b8", route="solve_flat_again", chips=1,
                why="a cell added as files only", limits={})  # fmt: skip
    (new / "workloads" / "extra_pendulum.b8.json").write_text(json.dumps(cell))
    (new / "metrics" / "calls_traced.py").write_text(
        'def read(rec):\n    return float(len(rec["trace"]["calls"]))\n'
    )
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append(dict(name="extra_pendulum.b8", config="extra_pendulum",
                                      traffic="one_client.b8", chips=1, why=cell["why"]))  # fmt: skip
    manifest["per_layer"].append(dict(name="calls_traced", unit="calls", better="higher", source="program_span",
                                      layer="harness", moves="call_ms_p95"))  # fmt: skip
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    out = drive(tmp_path, "extra_pendulum.b8", trace=True)["out"]
    assert out["metrics"]["calls_traced"]["value"] >= 1
    # the cell's own per-layer metrics only: the new one, which lists no
    # cells and so goes to every cell that reports the metric it moves
    assert set(out["metrics"]) == {"calls_traced"}
    after = _digest(tmp_path / "perfbench")
    assert {k: after[k] for k in before} == before
