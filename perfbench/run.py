"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``perfbench/workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``, whose
``kind`` names the generator ``traffic/<kind>.py``), its entry point
(``routes/<route>.py``) and the limits of the comparison that decides
``correct``.  The metrics a cell reports are those ``BENCHMARK.json`` lists
for it: end-to-end ones (``end_to_end/<name>.py``) with ``--trace 0``,
per-layer ones (``metrics/<name>.py``, read from the ``torch.profiler``
trace of the window's first ``TRACE_SECONDS``) with ``--trace 1``.  Everything is found by name, so a
new cell, configuration, mix, generator, route or metric is a new file.

Set-up (imports, the device, the kernel's library, the problem, the inputs
from ``--seed``, warm calls at the cell's size) is timed as
``setup_s``; then the traffic runs for ``--seconds``; then the compared
calls' results are checked against the plain reference.  The run needs the
card(s) the cell asks for and exits with 2 without a result when they are
missing, and with 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import resource  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# run as a script, the benchmark's folder is first on the path: put the
# checkout there instead, so its files shadow nothing
if sys.path and Path(sys.path[0]).resolve() == BENCH:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# build and kernel caches at fixed paths inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / ".perfbench_cache" / _dir)

import torch  # noqa: E402

from perfbench.reference import compare  # noqa: E402
from perfbench.trace_reduce import CALL_SPAN, reduce_trace  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "ddp_tpu"}
# warm calls, their results held together: as many as the window holds at
# once (the compared, the last and the one being made), so that the window
# finds every block it needs already allocated
N_WARM = 3
COMPARED_FROM = 16  # one compared call is drawn from the first 16, the last one is always compared
# a traced run records the window's first seconds: thousands of calls for the
# readers, and a trace that is written and read back in well under a minute
TRACE_SECONDS = 10.0


def load_json(*parts) -> dict:
    with open(BENCH.joinpath(*parts)) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``perfbench/<folder>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{folder}_{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {folder} file {path.relative_to(ROOT)}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest_metrics(cell: str, section: str) -> list:
    """The entries of ``BENCHMARK.json``'s ``section`` that ``cell`` reports:
    those that list it, and those without a ``workloads`` key (a per-layer
    one of those only where the cell reports the metric it moves)."""
    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    e2e = {m["name"] for m in manifest["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in manifest[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def segments(device) -> tuple[int, int]:
    """Device allocations the caching allocator has made so far, in its
    small and its large pool."""
    if device.type != "cuda":
        return 0, 0
    stats = torch.cuda.memory_stats(device)
    return tuple(stats.get(f"segment.{pool}_pool.allocated", 0) for pool in ("small", "large"))


def card_info(device) -> dict:
    """The card's name, clocks and power limit (``nvidia-smi``), or "not
    available"."""
    if device.type != "cuda":
        return dict(card="not available")
    query = "name,clocks.sm,clocks.max.sm,power.limit,power.draw,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )  # fmt: skip
        text = out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        text = f"nvidia-smi failed: {err}"
    return dict(card=text, query=query)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device="cuda", overrides=None,
             program=None, log=print) -> dict:  # fmt: skip
    """One run of ``cell``: returns the result line's object.  ``overrides``
    ({"config": {...}, "traffic": {...}}) changes entries of the cell's
    files, and ``program(route, call)`` wraps the timed call: both for tests
    and calibration, never for a benchmark run."""
    overrides = overrides or {}
    work = load_json("workloads", f"{cell}.json")
    cfg = {**load_json("configs", f"{work['config']}.json"), **overrides.get("config", {})}
    mix = {**load_json("traffic", f"{work['traffic']}.json"), **overrides.get("traffic", {})}
    limits = work.get("limits", {})
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    torch.set_num_threads(1)

    marks = [("imports", time.perf_counter())]
    route_mod = load_module("routes", work["route"])
    traffic = load_module("traffic", mix["kind"])
    marks.append(("program import", time.perf_counter()))
    route = route_mod.Route(cfg, device)
    inputs = traffic.make_inputs(mix, seed, route.nx, route.dtype, device)
    call = route.call if program is None else program(route, route.call)
    marks.append(("problem and inputs", time.perf_counter()))
    info = route.describe(inputs[0])
    marks.append(("library and launch plan", time.perf_counter()))
    warm = []
    for i in range(N_WARM):
        warm.append(route.fields(call(inputs[i % len(inputs)])))
        sync()
    lanes_per_call = int(mix["lanes"])
    warm_tally = route.tally(lanes_per_call, device)  # its operations loaded, at full size, before the window too
    for i in range(warm_tally.SLOTS if warm else 0):
        warm_tally.add(warm[i % len(warm)])
    warm_tally.read()
    del warm, warm_tally
    marks.append(("warm calls", time.perf_counter()))
    setup_s = marks[-1][1] - T_START
    counts = load_module("counts", route_mod.COUNTS).solve_counts(cfg, lanes_per_call)
    log(f"[cell] {cell} config={work['config']} traffic={work['traffic']} route={work['route']} "
        f"lanes={lanes_per_call} seed={seed} seconds={seconds} trace={int(trace)}")  # fmt: skip
    log("[setup] " + " ".join(f"{name.replace(' ', '_')}={t - t0:.3f}s"
                              for (name, t), (_, t0) in zip(marks, [("start", T_START)] + marks)))  # fmt: skip
    log(f"[plan] {json.dumps(info['plan'])}")
    log(f"[card] {json.dumps(card_info(device))}")
    log(f"[counts] ops={counts['ops']:.6g} bytes={counts['bytes']:.6g} bound_ms={counts['bound_ms']:.6g} "
        f"bound_by={counts['bound_by']} (published H100 SXM peaks at 700 W)")  # fmt: skip

    # the window
    tally = route.tally(lanes_per_call, device)
    keep = {random.Random(seed).randrange(COMPARED_FROM)}
    kept = {}
    harness_s = [0.0]  # the harness's own host time between calls

    def on_result(i, result):
        t0 = time.perf_counter()
        tally.add(route.fields(result))
        x0 = inputs[i % len(inputs)]
        if i in keep:
            kept[i] = (x0, result)
        kept["last"] = (i, x0, result)
        harness_s[0] += time.perf_counter() - t0

    gc.collect()
    gc.freeze()
    launches0 = route.launches()
    allocs0 = segments(device)
    usage0 = resource.getrusage(resource.RUSAGE_SELF)
    tmp = tempfile.TemporaryDirectory(prefix="perfbench-") if trace else contextlib.nullcontext()
    with tmp as tmpdir:
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
            prof.start()
        tracing = [trace]
        t_window = time.perf_counter()

        def after_call(i, result):
            on_result(i, result)
            if tracing[0] and time.perf_counter() - t_window >= TRACE_SECONDS:
                prof.stop()
                tracing[0] = False

        window = traffic.run(call, inputs, seconds, sync=sync, on_result=after_call,
                             span=(lambda: torch.profiler.record_function(CALL_SPAN)) if trace else None)  # fmt: skip
        sync()
        usage = resource.getrusage(resource.RUSAGE_SELF)
        if trace:
            if tracing[0]:
                prof.stop()
            path = os.path.join(tmpdir, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            trace_rec = reduce_trace(path)
        feasible, nonfinite = tally.read()
    gc.unfreeze()
    n_calls = len(window["starts"])
    cpu_ms = 1e3 * (usage.ru_utime + usage.ru_stime - usage0.ru_utime - usage0.ru_stime) / n_calls
    launches = (route.launches() - launches0) / n_calls
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    allocs = [n - n0 for n, n0 in zip(segments(device), allocs0)]
    in_order = [1e3 * (e - s) for s, e in zip(window["starts"], window["ends"])]
    call_ms = sorted(in_order)
    third = max(1, n_calls // 3)
    p50_thirds = [statistics.median(c) for c in (in_order[:third], in_order[third:-third], in_order[-third:]) if c]
    log(f"[window] calls={n_calls} launches_per_call={launches} feasible={feasible} nonfinite={nonfinite} "
        f"call_ms min={call_ms[0]:.4f} p50={call_ms[len(call_ms) // 2]:.4f} max={call_ms[-1]:.4f} "
        f"between_calls_ms={1e3 * (window['ends'][-1] - window['starts'][0]) / n_calls - sum(call_ms) / n_calls:.4f} "
        f"of_it_on_result_ms={1e3 * harness_s[0] / n_calls:.4f} "
        f"p50_by_third_ms={','.join(f'{v:.4f}' for v in p50_thirds)} device_allocs_small_large={allocs[0]},{allocs[1]} "
        f"cpu_ms_per_call={cpu_ms:.4f} preempted={usage.ru_nivcsw - usage0.ru_nivcsw} "
        f"yielded={usage.ru_nvcsw - usage0.ru_nvcsw}")  # fmt: skip

    # the check, with the program's state freed but for the compared results
    last_i, *last = kept.pop("last")
    kept.setdefault(last_i, tuple(last))
    x0s = torch.cat([x0 for x0, _ in kept.values()])
    got = [route.fields(result) for _, result in kept.values()]
    got = {k: torch.cat([f[k] for f in got]) for k in got[0]}
    del kept, last, call, route, inputs, tally
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, per_field = compare.judge(cfg, x0s, got)
    del got
    log(f"[check] lanes={x0s.shape[0]} seconds={time.perf_counter() - t_check:.3f}")
    # a lane whose result is not finite is an answer that says the wrong thing
    check = dict(nonfinite_lanes=dict(value=nonfinite, limit=0))
    check.update({k: dict(value=v, limit=limits.get(k)) for k, v in numbers.items()})
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in check.values())
    log(f"[fields] {json.dumps(per_field)}")

    starts, ends = window["starts"], window["ends"]
    rec = dict(
        setup_s=setup_s, lanes=lanes_per_call * n_calls, window_s=ends[-1] - starts[0],
        call_s=[e - s for s, e in zip(starts, ends)], feasible=feasible, counts=counts,
        trace=trace_rec if trace else None,
    )  # fmt: skip
    metrics = {}
    for m in manifest_metrics(cell, "per_layer" if trace else "end_to_end"):
        value = load_module("metrics" if trace else "end_to_end", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(
        platform="gpu" if on_card else "cpu",
        kind=torch.cuda.get_device_name(device) if on_card else "cpu",
        count=1, memory_peak_bytes=memory_peak,
    )  # fmt: skip
    out = dict(correct=correct, attempted=lanes_per_call * n_calls, failed=nonfinite, metrics=metrics, device=dev)
    if trace:
        dev.update(busy_s=trace_rec.get("busy_s", 0.0), window_s=trace_rec.get("window_s", 0.0))
        out["breakdown"] = dict(device_ops=trace_rec.get("device_ops", []), idle_gaps=trace_rec.get("idle_gaps", []))
    out["check"] = check
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    return out


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = int(load_json("workloads", f"{args.workload}.json")["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA card(s), this machine has {n}", file=sys.stderr)
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except ForbiddenImport as err:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {err.args[0]}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct = {out['correct']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
