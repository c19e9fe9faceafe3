"""Readings for the limits of the check that decides ``correct``: the
program on many seeds, the control (the reference in the program's place in
a lower precision), the witness (the reference in the program's place in
the configuration's own precision) and each planted fault on a few, all at the cell's own
size, in one process (the kernel's library is loaded once).  The control,
the witness and the faults are built from the reference the cell's route
names, so a new configuration's limits are calibrated the same way.  Prints one JSON
line per run with the compared numbers and, per field, the share of lanes
apart and the median and largest lane gap.

    python3 perfbench/calibrate.py --workload <cell> --seconds 1 \\
        --seeds 11 12 ... --control-seeds 21 22 23 --fault-seeds 31 32 33 \\
    --witness-seeds 41 42 43
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from perfbench import faults, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    work = run.load_json("workloads", f"{args.workload}.json")
    cfg = run.load_json("configs", f"{work['config']}.json")
    ref = run.load_module("reference", run.load_module("routes", work["route"]).REFERENCE)
    plan = [("program", s, None) for s in args.seeds]
    plan += [("control", s, faults.control(ref, cfg)) for s in args.control_seeds]
    plan += [("witness", s, faults.control(ref, cfg, ref.TYPES[cfg["dtype"]])) for s in args.witness_seeds]
    plan += [(name, s, make(ref, cfg)) for name, make in faults.FAULTS.items() for s in args.fault_seeds]
    for kind, seed, program in plan:
        t0 = time.perf_counter()
        lines = []
        out = run.run_cell(args.workload, seed, args.seconds, False, program=program, log=lines.append)
        fields = next((json.loads(x[len("[fields] "):]) for x in lines if x.startswith("[fields] ")), None)
        window = next((x for x in lines if x.startswith("[window]")), "")
        print(json.dumps(dict(
            kind=kind, seed=seed, check={k: v["value"] for k, v in out["check"].items()},
            correct=out["correct"], failed=out["failed"], attempted=out["attempted"], window=window,
            metrics={k: v["value"] for k, v in out["metrics"].items()}, fields=fields,
            seconds=time.perf_counter() - t0,
        )), flush=True)  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
