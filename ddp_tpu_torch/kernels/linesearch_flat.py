"""Fused line search of the batched solver for flat-lane problems
(≙ ddp_tpu/kernels/linesearch_flat.py).

``linesearch`` does the whole line search of one solver iteration: every
candidate step 2^-c rolls out the closed loop u = us + step·k + K·(x ⊖ xs) and
sums the augmented-Lagrangian cost l + p(x)·eq + (μ/2)‖eq‖²; one more row at
step 0 follows the stored trajectory and its cost is the incumbent's; each
lane takes the largest step whose cost did not rise, and keeps its
trajectory, bit for bit, with step 0 where none did.  Same semantics as
``solver/batched.py::_linesearch_sweep``.

On CUDA tensors it launches ``csrc/linesearch_flat.cu`` (one launch; the
problem's dynamics, cost and constraint run inside the kernel as the device
functions of its class, ``kernels/flat_problem.py``, from the library built
for the class's integrator, cost kind and row count); on CPU tensors it runs
``linesearch_reference``, the plain PyTorch version of the kernel's per-lane
program.  The multipliers must be anchored at the trajectory
(``origin == xs[:, :-1]``): the kernel evaluates p = val + jac·(x ⊖ xs).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ddp_tpu_torch.kernels import _build
from ddp_tpu_torch.kernels.flat_problem import FlatProblem, pack_problem
from ddp_tpu_torch.models.base import state_difference

SOURCE = "linesearch_flat.cu"
# a lane is a group of threads, one a candidate and one for the step-0 row
MAX_CANDIDATES = 31
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0


def linesearch_reference(
    problem,
    xs,  # [B, T+1, nx]
    us,  # [B, T, m]
    k,  # [B, T, m]
    K,  # [B, T, m, ndx]
    mult_val,  # [B, T, e]   (origin == xs[:, :-1])
    mult_jac,  # [B, T, e, ndx]
    mu,  # [B]
    n_candidates: int = 7,
):
    """Plain PyTorch version of the kernel: the same per-lane program on
    [rows, B] slabs, through the problem's own modules.

    The cost of a row is summed step by step, t = 0 … T−1 in turn and the
    terminal cost last, each step as ((l + p·ce) + ((½μ)·ce)·ce) per
    constraint row: the order the kernel keeps, since it decides ties in the
    acceptance test Δcost ≤ 0.  Returns (xs_new, us_new, step [B])."""
    B, T, m = us.shape
    e, ndx = mult_val.shape[-1], K.shape[-1]
    C = n_candidates
    model = problem.model
    kw = dict(dtype=xs.dtype, device=xs.device)
    mask = torch.as_tensor(problem.eq_mask(), **kw)  # [T, e]
    active = set(problem.active_ts())

    def feedback_u(t, dx, step):
        cols = []
        for i in range(m):
            s = us[:, t, i] + step * k[:, t, i]
            for j in range(ndx):
                s = s + K[:, t, i, j] * dx[..., j]
            cols.append(s)
        return torch.stack(cols, dim=-1)

    def rollout(step):
        """step [R, 1] or [1, B] → (cost [R, B], xs [R, B, T+1, nx], us)."""
        R = step.shape[0]
        x = xs[:, 0].expand(R, B, xs.shape[-1])
        cost = torch.zeros((R, B), **kw)
        xs_r, us_r = [x], []
        for t in range(T):
            dx = state_difference(model, xs[:, t], x)
            u = feedback_u(t, dx, step)
            ct = problem.cost.stage(t, x, u)
            if e and t in active:
                ce = problem.constraint.value(t, x, u) * mask[t]
                for a in range(e):
                    p = mult_val[:, t, a]
                    for j in range(ndx):
                        p = p + mult_jac[:, t, a, j] * dx[..., j]
                    ct = ct + p * ce[..., a] + 0.5 * mu * ce[..., a] * ce[..., a]
            cost = cost + ct
            x = problem.dynamics(t, x, u)
            xs_r.append(x)
            us_r.append(u)
        cost = cost + problem.cost.terminal(x)
        return cost, torch.stack(xs_r, dim=2), torch.stack(us_r, dim=2)

    # the step ladder 1, ½, …, 2^-(C-1), and the step-0 row: the incumbent
    steps = torch.tensor([2.0**-c for c in range(C)] + [0.0], **kw)
    costs, _, _ = rollout(steps[:, None])
    cost0 = costs[C]
    chosen = torch.zeros(B, **kw)
    taken = torch.zeros(B, dtype=torch.bool, device=xs.device)
    for c in range(C):
        acc = costs[c] - cost0 <= 0
        chosen = torch.where(acc & ~taken, steps[c], chosen)
        taken = taken | acc
    # second rollout at the lane's chosen step; rejected lanes keep their own
    _, xs_c, us_c = rollout(chosen[None, :])
    xs_new = torch.where(taken[:, None, None], xs_c[0], xs)
    us_new = torch.where(taken[:, None, None], us_c[0], us)
    return xs_new, us_new, chosen


def linesearch(
    problem, xs, us, k, K, mult_val, mult_jac, mu, n_candidates: int = 7, flat=None
):
    """Batch-major fused line search: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (xs_new [B, T+1, nx],
    us_new [B, T, m], step [B]).

    ``n_candidates`` ≥ 1 is the depth of the step ladder 1, ½, …; the kernel
    takes up to 31 (ddp_tpu's TPU kernel takes 7: its eight sublanes carry the
    ladder and the step-0 row).  ``flat``: the problem as
    ``flat_problem.pack_problem`` packs it, which a caller that runs many line
    searches on one problem packs once; packed here when not given.  The plain
    version reads the problem itself."""
    if n_candidates < 1:
        raise ValueError(f"n_candidates must be >= 1, got {n_candidates}")
    if xs.device.type == "cpu":
        return linesearch_reference(
            problem, xs, us, k, K, mult_val, mult_jac, mu, n_candidates
        )
    plan = plan_launch(problem, xs, us, k, K, mult_val, mult_jac, mu, n_candidates, flat)
    return launch_plan(plan)


class LaunchPlan(NamedTuple):
    """One launch of the kernel, ready to go: the batch-major device tensors
    (inputs, then the outputs it writes) and the packed problem.  A plan can
    be launched again.  Each launch fills ``geometry`` with the kernel's own
    launch plan: threads a lane, lanes a block and shared-memory bytes a
    block."""

    tensors: list  # xs, us, k, K, mult_val, mult_jac, mask, mu, xs_out, us_out, step
    flat: FlatProblem
    n_candidates: int
    geometry: dict


def plan_launch(
    problem, xs, us, k, K, mult_val, mult_jac, mu, n_candidates: int = 7, flat=None
) -> LaunchPlan:
    """Check the batch-major inputs against the problem's flat-lane class and
    the kernel's instantiations and allocate the outputs.  A non-contiguous
    input is made contiguous; nothing is transposed or copied to the device."""
    if flat is None:
        flat = pack_problem(problem)
    B, Tp1, nx = xs.shape
    T, m, e = Tp1 - 1, us.shape[-1], mult_val.shape[-1]
    dtype, dev = xs.dtype, xs.device
    if (nx, m, e) != (flat.nx, flat.m, flat.e):
        raise ValueError(
            f"(nx, m, e)={(nx, m, e)} for a packed problem of {(flat.nx, flat.m, flat.e)}"
        )
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    if not 1 <= n_candidates <= MAX_CANDIDATES:
        raise ValueError(
            f"the kernel takes 1 to {MAX_CANDIDATES} candidates, got {n_candidates}"
        )
    if T < 1:
        raise ValueError(f"the kernel takes a horizon of at least 1 step, got {T}")
    expected = dict(
        xs=(B, T + 1, nx), us=(B, T, m), k=(B, T, m), K=(B, T, m, nx),
        mult_val=(B, T, e), mult_jac=(B, T, e, nx), mask=(T, e), mu=(B,),
        consts=tuple(flat.consts.shape),
    )  # fmt: skip
    given = dict(xs=xs, us=us, k=k, K=K, mult_val=mult_val, mult_jac=mult_jac,
                 mask=flat.mask, mu=mu, consts=flat.consts)  # fmt: skip
    for name, x in given.items():
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {dtype} on {dev}")
        if tuple(x.shape) != expected[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {expected[name]}")
    if T != flat.horizon:
        raise ValueError(f"trajectory of {T} steps for a problem of horizon {flat.horizon}")
    inputs = [given[n].contiguous() for n in ("xs", "us", "k", "K", "mult_val", "mult_jac",
                                              "mask", "mu")]  # fmt: skip
    outputs = [torch.empty_like(inputs[0]), torch.empty_like(inputs[1]), torch.empty_like(mu)]
    return LaunchPlan(inputs + outputs, flat, n_candidates, {})


def launch_plan(plan: LaunchPlan):
    """Launch the kernel once on ``plan``.  Returns the plan's output tensors
    (xs [B, T+1, nx], us [B, T, m], step [B]), contiguous batch-major."""
    global LAUNCHES
    xs, us = plan.tensors[0], plan.tensors[1]
    (B, Tp1, nx), m, flat = xs.shape, us.shape[-1], plan.flat
    ptrs = (ctypes.c_void_p * len(plan.tensors))(*[x.data_ptr() for x in plan.tensors])
    fn = _kernel_fn(flat.build)
    geometry = (ctypes.c_int * 3)()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = fn(
            int(xs.dtype == torch.float64), flat.dynamics, flat.cost, flat.e, Tp1 - 1, B,
            plan.n_candidates, ctypes.cast(ptrs, ctypes.c_void_p), flat.consts.data_ptr(),
            ctypes.cast(geometry, ctypes.c_void_p), stream,
        )  # fmt: skip
    if rc == -1:  # the only gate plan_launch cannot check: the shared memory
        raise ValueError(_NO_FIT.format(T=Tp1 - 1, C=plan.n_candidates, e=flat.e, dtype=xs.dtype))
    if rc == -2:
        raise RuntimeError(f"linesearch_flat: the library does not serve the class {flat.build}")
    if rc != 0:
        raise RuntimeError(f"linesearch_flat kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    plan.geometry.update(threads_per_lane=geometry[0], lanes_per_block=geometry[1],
                         smem_bytes=geometry[2])  # fmt: skip
    return tuple(plan.tensors[8:11])


_NO_FIT = (
    "the line-search kernel keeps a lane's inputs and its candidates' rollouts in "
    "one block's shared memory (232,448 bytes): T = {T} with {C} candidates and "
    "e = {e} in {dtype} does not fit (every T <= 256 does at e <= 3, up to 31 "
    "candidates in float64)"
)


def _kernel_fn(build: dict):
    """The kernel of the library built for a class's ``FlatProblem.build``
    constants (prebuilt with ``_kernel_fn({"DYN": 0, "COST": 0, "E": 1})``)."""
    lib = _build.load(SOURCE, build)
    fn = lib.ddp_linesearch_flat
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn
