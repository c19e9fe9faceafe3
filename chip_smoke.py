#!/usr/bin/env python3
"""Run ddp_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

1. device: the card's name and power limit (nvidia-smi), torch/CUDA versions;
   TF32 off for matmuls and cuDNN.
2. build: compiles csrc/riccati_small.cu with nvcc (sm_90a).
3. kernel vs plain version on the card, numpy-seeded inputs: (n, m, e) =
   (2, 1, 1) at B=4096, T=32 in f32 and f64, (12, 6, 6) at B=512, T=16 in
   f64, a ragged B=1000, and one lane forced non-PD.
4. main path: bench.py's headline (4096 constrained pendulum swing-ups,
   T=32, f32, 8 AL iterations, inner_iters_max=1) through solve_batched with
   backward="kernel"; checks the kernel's launch count, finiteness and
   feasibility, then the same solve with backward="sweep" (lanes agree on us
   within 1e-3 of their largest |u|), and both again in f64 (1e-8, identical μ).
5. times: kernel vs plain backward at the headline shape (CUDA events,
   median of 20) and headline solves/s (median of 3 after a warm-up).

Every phase prints one line; any failure raises and the exit code is not 0.
The last lines are a JSON object describing the kernel and the JSON result
{"ok": true, "device": {...}}.  There is no CPU path.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels import _build
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.ocp.problem import Derivs
from ddp_tpu_torch.solver import al
from ddp_tpu_torch.solver.batched import solve_batched
from ddp_tpu_torch.solver.solve import SolverParams

B, T = 4096, 32
HEADLINE = SolverParams(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
HEADLINE_KW = dict(n_reg_levels=1, n_linesearch=4)
SPEC = dict(
    mass=1.0, length=1.0, dt=0.01, c=1.0, target=np.array([3.14]),
    active_ts=(T,), advance_times=2, horizon=T, second_order=False,
)  # fmt: skip
# pre-loop + 8 iterations, one reg level each
EXPECTED_LAUNCHES = 1 + HEADLINE.max_iterations
DEV = "cuda"


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def headline_x0s(dtype):
    """bench.py's initial states: q ~ U(-π, π) from default_rng(0), v = 0."""
    rng = np.random.default_rng(0)
    x0 = np.stack([rng.uniform(-np.pi, np.pi, B), np.zeros(B)], axis=1)
    return torch.tensor(x0, dtype=dtype, device=DEV)


# ------------------------------------------------------------ kernel inputs


def pendulum_inputs(Bk, dtype, bad_lane=None):
    """Pendulum derivatives along a numpy-seeded rollout with non-trivial
    multipliers, packed [T, rows, B] (≙ tests/test_pallas_riccati.py's
    make_batch)."""
    rng = np.random.default_rng(1)
    problem = problem_from_numpy(dict(SPEC, target=np.array([2.0])), device=DEV, dtype=dtype)
    kw = dict(dtype=dtype, device=DEV)
    x0s = torch.tensor(0.4 * rng.normal(size=(Bk, 2)), **kw)
    us = torch.tensor(0.3 * rng.normal(size=(Bk, T, 1)), **kw)
    xs = problem.rollout(x0s, us)
    derivs = problem.derivatives(xs, us)
    mults = al.init_multipliers(problem, xs)
    val = torch.tensor(0.3 * rng.normal(size=mults.val.shape), **kw)
    jac = torch.tensor(0.1 * rng.normal(size=mults.jac.shape), **kw)
    if bad_lane is not None:
        luu = derivs.luu.clone()
        luu[bad_lane] = -10.0
        derivs = derivs._replace(luu=luu)
    mu = torch.full((Bk,), 1e3, **kw)
    reg = torch.zeros(Bk, **kw)
    return rs.pack_batch_last(derivs, val, jac), mu, reg


def spd_inputs(Bk, Tk, n, m, e, dtype):
    """Random Gauss-Newton blocks at arbitrary dims: fx near I, an SPD
    stage-cost Hessian, non-trivial constraint rows and multipliers."""
    rng = np.random.default_rng(3)
    nz = n + m
    G = rng.normal(size=(Bk, Tk, nz, nz)) / np.sqrt(nz)
    lzz = G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(nz)
    lfG = rng.normal(size=(Bk, n, n)) / np.sqrt(n)
    z = np.zeros
    f = dict(
        lx=rng.normal(size=(Bk, Tk, n)), lu=rng.normal(size=(Bk, Tk, m)),
        lxx=lzz[..., :n, :n], lux=lzz[..., n:, :n], luu=lzz[..., n:, n:],
        fx=np.eye(n) + 0.05 * rng.normal(size=(Bk, Tk, n, n)),
        fu=0.1 * rng.normal(size=(Bk, Tk, n, m)),
        fxx=z((Bk, Tk, n, n, n)), fux=z((Bk, Tk, n, m, n)), fuu=z((Bk, Tk, n, m, m)),
        eq=0.1 * rng.normal(size=(Bk, Tk, e)),
        eqx=0.1 * rng.normal(size=(Bk, Tk, e, n)),
        equ=0.1 * rng.normal(size=(Bk, Tk, e, m)),
        eqxx=z((Bk, Tk, e, n, n)), equx=z((Bk, Tk, e, m, n)), equu=z((Bk, Tk, e, m, m)),
        lfx=rng.normal(size=(Bk, n)),
        lfxx=lfG @ np.swapaxes(lfG, -1, -2) + 0.1 * np.eye(n),
    )  # fmt: skip
    kw = dict(dtype=dtype, device=DEV)
    derivs = Derivs(**{k: torch.tensor(np.ascontiguousarray(v), **kw) for k, v in f.items()})
    pe = torch.tensor(0.3 * rng.normal(size=(Bk, Tk, e)), **kw)
    pex = torch.tensor(0.01 * rng.normal(size=(Bk, Tk, e, n)), **kw)
    mu = torch.full((Bk,), 1e3, **kw)
    reg = torch.full((Bk,), 1e-6, **kw)
    return rs.pack_batch_last(derivs, pe, pex), mu, reg


def kernel_vs_plain(name, packed, mu, reg, Tk, n, m, e, rtol, atol):
    """Run the kernel and the plain version on the same card tensors; raise
    unless k, K agree within (rtol, atol) and the ok vectors are equal.
    Returns the max abs error and the ok vector."""
    got = rs.backward_sweep(packed, mu, reg, T=Tk, n=n, m=m, e=e)
    torch.cuda.synchronize()
    ref = rs.backward_sweep_reference(packed, mu, reg, T=Tk, n=n, m=m, e=e)
    check(torch.equal(got[2], ref[2]), f"{name}: ok vectors differ")
    err = 0.0
    for a, b, label in zip(got[:2], ref[:2], ("k", "K")):
        keep = ref[2]  # failed lanes are NaN in both
        a, b = a[..., keep], b[..., keep]
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite {label}")
        check(
            torch.allclose(a, b, rtol=rtol, atol=atol),
            f"{name}: {label} max err {float((a - b).abs().max())}",
        )
        err = max(err, float((a - b).abs().max()))
    say("kernel", case=name, max_abs_err=f"{err:.3e}", rtol=rtol, atol=atol,
        ok_lanes=f"{int(got[2].sum())}/{got[2].numel()}")  # fmt: skip
    return err, got[2]


# ------------------------------------------------------------------ timing


def event_ms(fn, reps=20):
    """Median over ``reps`` single calls of the device time between CUDA
    events around ``fn`` (after one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def solve(problem, x0s, backward):
    res = solve_batched(problem, HEADLINE, x0s, backward=backward, **HEADLINE_KW)
    torch.cuda.synchronize()
    return res


def main_path():
    """Phase 4: the headline solve through the kernel, its checks, and the
    sweep-backend and f64 comparisons.  Returns (launches, problem, x0s)."""
    p32 = problem_from_numpy(SPEC, device=DEV, dtype=torch.float32)
    x32 = headline_x0s(torch.float32)
    rs.LAUNCHES = 0
    res_k = solve(p32, x32, "kernel")
    launches = rs.LAUNCHES
    check(launches == EXPECTED_LAUNCHES, f"kernel launches {launches} != {EXPECTED_LAUNCHES}")
    for name in ("xs", "us", "fb_k", "fb_K", "opt_constr", "opt_lag", "mu", "reg", "w", "n"):
        check(bool(torch.isfinite(getattr(res_k, name)).all()), f"non-finite {name}")
    feas_k = float((res_k.opt_constr < 1e-2).float().mean())
    check(feas_k >= 0.99, f"f32 feasible fraction {feas_k}")
    res_s = solve(p32, x32, "sweep")
    feas_s = float((res_s.opt_constr < 1e-2).float().mean())
    # a lane agrees when max_t |Δus| <= 1e-3 · max(1, max_t |us|).  A bare
    # 1e-3 is below what f32 resolves here: |us| reaches ~180 and the step
    # under the constraint is conditioned by μ up to 1e9, so ddp_tpu's own
    # f32 Pallas and sweep backends leave ~30% of lanes more than 1e-3 apart
    # (up to ~4e-3) on the CPU
    diff = (res_k.us - res_s.us).abs().amax(dim=(1, 2))
    scale = res_s.us.abs().amax(dim=(1, 2)).clamp(min=1.0)
    agree = float((diff <= 1e-3 * scale).float().mean())
    agree_abs = float((diff <= 1e-3).float().mean())
    check(abs(feas_k - feas_s) <= 0.005, f"feasible fractions {feas_k} vs {feas_s}")
    check(agree >= 0.99, f"only {agree} of lanes agree on us to 1e-3 of their scale")
    say("main_f32", B=B, T=T, launches=launches, feasible_kernel=feas_k,
        feasible_sweep=feas_s, lanes_us_agree=agree, lanes_us_within_abs_1em3=agree_abs,
        us_max_err=f"{float(diff.max()):.3e}",
        us_max_scaled_err=f"{float((diff / scale).max()):.3e}",
        mu_equal=float((res_k.mu == res_s.mu).float().mean()),
        p99_eq=f"{float(torch.quantile(res_k.opt_constr, 0.99)):.3e}")  # fmt: skip

    p64 = problem_from_numpy(SPEC, device=DEV, dtype=torch.float64)
    x64 = headline_x0s(torch.float64)
    r64_k, r64_s = solve(p64, x64, "kernel"), solve(p64, x64, "sweep")
    err64 = float((r64_k.us - r64_s.us).abs().max())
    check(err64 <= 1e-8, f"f64 us max err {err64}")
    check(torch.equal(r64_k.mu, r64_s.mu), "f64 per-lane mu differs")
    feas64 = float((r64_k.opt_constr < 1e-2).float().mean())
    say("main_f64", us_max_err=f"{err64:.3e}", mu_identical=True, feasible_kernel=feas64,
        mu_levels=sorted({float(v) for v in r64_k.mu}))  # fmt: skip
    return launches, p32, x32


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)  # fmt: skip

    # 2. build
    rs._kernel_fn()
    say("build", source=rs.SOURCE, nvcc_s=f"{_build.build_seconds(rs.SOURCE):.1f}")

    # 3. kernel vs plain version
    f32_in = pendulum_inputs(B, torch.float32)
    err32, _ = kernel_vs_plain("headline_f32_B4096_T32", *f32_in, T, 2, 1, 1, 2e-4, 2e-5)
    kernel_vs_plain("headline_f64_B4096_T32", *pendulum_inputs(B, torch.float64),
                    T, 2, 1, 1, 1e-10, 1e-10)  # fmt: skip
    kernel_vs_plain("ur5dims_f64_B512_T16", *spd_inputs(512, 16, 12, 6, 6, torch.float64),
                    16, 12, 6, 6, 1e-9, 1e-9)  # fmt: skip
    kernel_vs_plain("ragged_f64_B1000_T32", *pendulum_inputs(1000, torch.float64),
                    T, 2, 1, 1, 1e-10, 1e-10)  # fmt: skip
    _, ok = kernel_vs_plain("nonpd_lane3_f64_B1000", *pendulum_inputs(1000, torch.float64, 3),
                            T, 2, 1, 1, 1e-10, 1e-10)  # fmt: skip
    check(not bool(ok[3]) and int(ok.sum()) == ok.numel() - 1, "only lane 3 may fail")

    # 4. main path
    launches, p32, x32 = main_path()

    # 5. times
    packed, mu, reg = f32_in
    ms = event_ms(lambda: rs.backward_sweep(packed, mu, reg, T=T, n=2, m=1, e=1))
    plain_ms = event_ms(
        lambda: rs.backward_sweep_reference(packed, mu, reg, T=T, n=2, m=1, e=1)
    )
    say("time_backward", card=f"'{card}'", shape=f"n2m1e1_T{T}_B{B}_f32",
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")  # fmt: skip
    solve(p32, x32, "kernel")  # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve(p32, x32, "kernel")
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    say("time_solve", card=f"'{card}'", backward="kernel", B=B,
        solve_s=[f"{w:.4f}" for w in walls], solves_per_s=f"{B / wall:.1f}",
        peak_mem_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.1f}")  # fmt: skip

    print(json.dumps({"kernels": [{
        "name": "riccati_small_bwd", "route": "cuda",
        "source": "ddp_tpu_torch/csrc/riccati_small.cu",
        "replaces": "ddp_tpu/kernels/riccati_small.py:379",
        "launches": launches, "max_abs_err": err32, "ms": ms, "plain_ms": plain_ms,
    }]}))  # fmt: skip
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))  # fmt: skip


if __name__ == "__main__":
    main()
