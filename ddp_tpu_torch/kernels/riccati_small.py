"""Batched small-dimension Riccati backward sweep over a whole
regularization ladder (≙ ddp_tpu/kernels/riccati_small.py, which ddp_tpu
launches once per reg level).

``backward_ladder`` takes batch-major ``Derivs`` ([B, T, …]), the multipliers,
μ [B] and the ladder's levels [L, B], sweeps every level and keeps per lane
the first one whose factorization held: (k [B, T, m], K [B, T, m, n],
ok [B], reg_used [B]).  On CUDA tensors that is one launch of
``csrc/riccati_small.cu``, reading the batch-major tensors as they are (one
block per lane and a warp per level at n ≥ 12, one thread per lane and level
below), from the library nvcc built for that (n, m, e) and order at its
first call (``instantiation``, ``_build.load``); on CPU tensors it is the
plain PyTorch version ``backward_ladder_reference``, one
``backward_sweep_reference`` per level over the batch-last
``pack_batch_last`` layout below.  AL multiplier terms
throughout; with ``second_order`` the six rank-3 slabs ``fxx … equu`` add
``Vx·fxx + tmp·eqxx`` and its ux/uu counterparts to the Q expansion, without
them it is the Gauss-Newton form.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ddp_tpu_torch.kernels import _build

SOURCE = "riccati_small.cu"
# n from which a lane takes a block (a warp a level) instead of a thread a
# level, and the widths that program takes (a right-hand side of the 1 + n,
# and a row below a Cholesky pivot, a lane of a warp)
LARGE_N = 12
LARGE_MAX_N, LARGE_MAX_M = 31, 32
# the most reg levels one launch sweeps (a warp, or a row of threads, each)
MAX_LEVELS = 16
# kernel launches since import (or since a caller reset it), how many of
# them ran a second-order library, and the reg levels they swept
LAUNCHES = 0
LAUNCHES_SECOND_ORDER = 0
LEVELS_SWEPT = 0

_INPUTS = (
    "lx", "lu", "lxx", "lux", "luu", "fx", "fu",
    "eq", "eqx", "equ", "pe", "pex",
)  # fmt: skip
# the rank-3 slabs of a full-DDP sweep, row index (o·r + i)·c + j
_INPUTS_SECOND_ORDER = ("fxx", "fux", "fuu", "eqxx", "equx", "equu")


def pack_batch_last(derivs, mult_val, mult_jac, second_order: bool = False):
    """Batch-major Derivs ([B, T, …]) → a dict of [T, rows, B] arrays, plus
    the terminal lfx [n, B] and lfxx [n*n, B]: the layout of the plain
    version.  With ``second_order`` the
    six rank-3 tensor blocks ride along for the full-DDP sweep."""

    def mv(x, rows):
        b, t = x.shape[0], x.shape[1]
        return x.reshape(b, t, rows).permute(1, 2, 0).contiguous()

    def mv_const(x, rows):
        return x.reshape(x.shape[0], rows).T.contiguous()

    n = derivs.lx.shape[-1]
    m = derivs.lu.shape[-1]
    e = derivs.eq.shape[-1]
    out = dict(
        lx=mv(derivs.lx, n), lu=mv(derivs.lu, m),
        lxx=mv(derivs.lxx, n * n), lux=mv(derivs.lux, m * n), luu=mv(derivs.luu, m * m),
        fx=mv(derivs.fx, n * n), fu=mv(derivs.fu, n * m),
        eq=mv(derivs.eq, e), eqx=mv(derivs.eqx, e * n), equ=mv(derivs.equ, e * m),
        pe=mv(mult_val, e), pex=mv(mult_jac, e * n),
        lfx=mv_const(derivs.lfx, n), lfxx=mv_const(derivs.lfxx, n * n),
    )  # fmt: skip
    if second_order:
        out.update(
            fxx=mv(derivs.fxx, n * n * n), fux=mv(derivs.fux, n * m * n),
            fuu=mv(derivs.fuu, n * m * m),
            eqxx=mv(derivs.eqxx, e * n * n), equx=mv(derivs.equx, e * m * n),
            equu=mv(derivs.equu, e * m * m),
        )  # fmt: skip
    return out


def _rows(n, m, e, second_order=False):
    """Rows of each per-step [T, rows, B] input."""
    rows = dict(
        lx=n, lu=m, lxx=n * n, lux=m * n, luu=m * m, fx=n * n, fu=n * m,
        eq=e, eqx=e * n, equ=e * m, pe=e, pex=e * n,
    )  # fmt: skip
    if second_order:
        rows.update(
            fxx=n * n * n, fux=n * m * n, fuu=n * m * m,
            eqxx=e * n * n, equx=e * m * n, equu=e * m * m,
        )  # fmt: skip
    return rows


def _chol_solve(A, R, reg):
    """Factor A + reg·I (A [B, m, m]) by an unrolled Cholesky–Banachiewicz
    and solve for the columns of R [B, m, c].  Returns (X [B, m, c], the
    diagonal of L as a list of [B] vectors).  A non-PD lane gets NaN through
    sqrt of a negative pivot, as the kernel does."""
    m = A.shape[-1]
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = A[:, i, j] + (reg if i == j else 0.0)
            for q in range(j):
                s = s - L[i][q] * L[j][q]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    y = [None] * m
    for i in range(m):  # forward: L y = R
        s = R[:, i]
        for q in range(i):
            s = s - L[i][q][:, None] * y[q]
        y[i] = s / L[i][i][:, None]
    x = [None] * m
    for i in reversed(range(m)):  # backward: Lᵀ x = y
        s = y[i]
        for q in range(i + 1, m):
            s = s - L[q][i][:, None] * x[q]
        x[i] = s / L[i][i][:, None]
    return torch.stack(x, dim=1), [L[i][i] for i in range(m)]


def backward_sweep_reference(derivs_bl: dict, mu, reg, *, T, n, m, e):
    """One level of the plain version: the sweep at reg [B] in batched tensor
    ops over the lanes of each [rows, B] slab of ``pack_batch_last``'s dict;
    the second-order terms are added when it holds the rank-3 slabs.

    Returns (k [T, m, B], K [T, m*n, B], ok [B] bool)."""
    d = derivs_bl
    B = d["lx"].shape[-1]
    kw = dict(dtype=d["lx"].dtype, device=d["lx"].device)

    def blk(name, t, r, c):  # [rows, B] slab → [B, r, c]
        return d[name][t].T.reshape(B, r, c)

    def tmv(A, x):  # Aᵀ·x per lane
        return (A.mT @ x[..., None])[..., 0]

    def contract(v, name, t, r, c):  # Σ_o v[o]·H[o, :, :] per lane → [B, r, c]
        H = d[name][t].T.reshape(B, v.shape[-1], r * c)
        return (v[:, None, :] @ H).reshape(B, r, c)

    second_order = "fxx" in d
    Vx = d["lfx"].T
    Vxx = d["lfxx"].T.reshape(B, n, n)
    mu1, mu2 = mu[:, None], mu[:, None, None]
    ok = torch.ones(B, dtype=torch.bool, device=kw["device"])
    k_out = torch.empty((T, m, B), **kw)
    K_out = torch.empty((T, m * n, B), **kw)
    for t in reversed(range(T)):
        fx, fu = blk("fx", t, n, n), blk("fu", t, n, m)
        eq, pe = d["eq"][t].T, d["pe"][t].T
        eqx, equ, pex = blk("eqx", t, e, n), blk("equ", t, e, m), blk("pex", t, e, n)
        tmp = pe + mu1 * eq
        tmp2 = pex + mu2 * eqx
        Qx = d["lx"][t].T + tmv(fx, Vx) + tmv(eqx, tmp) + tmv(pex, eq)
        Qu = d["lu"][t].T + tmv(fu, Vx) + tmv(equ, tmp)
        Vfx, Vfu = Vxx @ fx, Vxx @ fu
        Qxx = blk("lxx", t, n, n) + fx.mT @ Vfx + eqx.mT @ tmp2 + pex.mT @ eqx
        Quu = blk("luu", t, m, m) + fu.mT @ Vfu + mu2 * (equ.mT @ equ)
        Qux = blk("lux", t, m, n) + fu.mT @ Vfx + equ.mT @ tmp2
        if second_order:
            Qxx = Qxx + contract(Vx, "fxx", t, n, n) + contract(tmp, "eqxx", t, n, n)
            Quu = Quu + contract(Vx, "fuu", t, m, m) + contract(tmp, "equu", t, m, m)
            Qux = Qux + contract(Vx, "fux", t, m, n) + contract(tmp, "equx", t, m, n)
        X, diag = _chol_solve(Quu, torch.cat([Qu[..., None], Qux], dim=-1), reg)
        for lii in diag:
            ok = ok & (lii > 0) & torch.isfinite(lii)
        k_out[t] = -X[:, :, 0].T
        K_out[t] = -X[:, :, 1:].reshape(B, m * n).T
        Vx = Qx - tmv(Qux, X[:, :, 0])
        Vxx = Qxx - Qux.mT @ X[:, :, 1:]
    return k_out, K_out, ok


def backward_ladder_reference(derivs, mult_val, mult_jac, mu, levels, second_order=False):
    """Plain PyTorch version of the kernel: ``backward_sweep_reference`` at
    each level of ``levels`` [L, B], keeping per lane the first level whose
    factorization held (level 0's gains and reg where none did).  Returns
    batch-major (k [B, T, m], K [B, T, m, n], ok [B], reg_used [B])."""
    B, T = derivs.lx.shape[0], derivs.lx.shape[1]
    n, m, e = derivs.lx.shape[-1], derivs.lu.shape[-1], derivs.eq.shape[-1]
    packed = pack_batch_last(derivs, mult_val, mult_jac, second_order=second_order)
    k = K = None
    ok_acc = torch.zeros(B, dtype=torch.bool, device=mu.device)
    reg_used = levels[0]
    for lvl in levels:
        k_i, K_i, ok_i = backward_sweep_reference(packed, mu, lvl, T=T, n=n, m=m, e=e)
        newly = ~ok_acc & ok_i
        if k is None:
            k, K = k_i, K_i
        else:
            k = torch.where(newly, k_i, k)
            K = torch.where(newly, K_i, K)
        reg_used = torch.where(newly, lvl, reg_used)
        ok_acc = ok_acc | ok_i
    return k.permute(2, 0, 1), K.reshape(T, m, n, B).permute(3, 0, 1, 2), ok_acc, reg_used


def backward_ladder(derivs, mult_val, mult_jac, mu, levels, second_order=False):
    """The Riccati sweep at every reg level of ``levels`` [L, B] over the
    whole batch, keeping per lane the first level that factorized: one
    kernel launch for CUDA tensors, the plain version for CPU tensors.
    ``derivs`` is batch-major ``Derivs`` (with the rank-3 slabs when
    ``second_order``), ``mult_val`` [B, T, e], ``mult_jac`` [B, T, e, n],
    ``mu`` [B].  Returns (k [B, T, m], K [B, T, m, n], ok [B], reg_used [B])."""
    if mu.device.type == "cpu":
        return backward_ladder_reference(derivs, mult_val, mult_jac, mu, levels, second_order)
    return launch_plan(plan_launch(derivs, mult_val, mult_jac, mu, levels, second_order))


def instantiation(n, m, e, second_order=False) -> dict:
    """The build constants of the library that serves (n, m, e) and the
    order: one nvcc build a shape, made at its first call (``_build``).
    Raises ValueError for a shape the source does not take."""
    if min(n, m, e) < 1:
        raise ValueError(f"the kernel takes n, m, e >= 1, got (n, m, e)={(n, m, e)}")
    if n >= LARGE_N and (n > LARGE_MAX_N or m > LARGE_MAX_M):
        raise ValueError(
            f"(n, m, e)={(n, m, e)}: the kernel's large-dims program takes "
            f"n <= {LARGE_MAX_N} and m <= {LARGE_MAX_M} (a lane of a warp each)"
        )
    return {"N": n, "M": m, "E": e, "SO": int(second_order)}


def kernel_inputs(derivs, mult_val, mult_jac, mu, levels, second_order=False):
    """Check a call against the kernel's gates, and return the tensors it
    reads, contiguous, by name: the per-step fields (batch-major
    [B, T, rows]), mu, levels, lfx [B, n] and lfxx [B, n*n].  Raises
    ValueError or TypeError for what the kernel does not take."""
    B, T = derivs.lx.shape[0], derivs.lx.shape[1]
    n, m, e = derivs.lx.shape[-1], derivs.lu.shape[-1], derivs.eq.shape[-1]
    instantiation(n, m, e, second_order)
    dtype, dev = mu.dtype, mu.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    L = levels.shape[0]
    if levels.dim() != 2 or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"levels must be [L, B] with 1 <= L <= {MAX_LEVELS}, got {tuple(levels.shape)}")
    rows = _rows(n, m, e, second_order)
    # a lane's step slab of each batch-major field is contiguous, its trailing
    # dims flattened row-major (the rank-3 slabs in row (o·r + i)·c + j)
    fields = {k: getattr(derivs, k) for k in rows if k not in ("pe", "pex")}
    fields.update(pe=mult_val, pex=mult_jac)
    tensors = {k: x.flatten(2).contiguous() for k, x in fields.items()}
    tensors.update(mu=mu, levels=levels, lfx=derivs.lfx, lfxx=derivs.lfxx.flatten(1))
    expected = {k: (B, T, r) for k, r in rows.items()}
    expected.update(mu=(B,), levels=(L, B), lfx=(B, n), lfxx=(B, n * n))
    for k, x in tensors.items():
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{k}: {x.dtype} on {x.device}, expected {dtype} on {dev}")
        if tuple(x.shape) != expected[k]:
            raise ValueError(f"{k}: shape {tuple(x.shape)}, expected {expected[k]}")
    return {k: x.contiguous() for k, x in tensors.items()}


class LaunchPlan(NamedTuple):
    """What one launch reads and writes: the C entry point's integer
    arguments (is_double, second_order, n, m, e, T, B, L), its inputs in
    order, the per-level scratch and the outputs (k, K, ok, reg_used)."""

    ints: tuple
    inputs: tuple
    scratch: tuple
    outputs: tuple


def plan_launch(derivs, mult_val, mult_jac, mu, levels, second_order=False) -> LaunchPlan:
    """Check a call against the kernel's gates and lay out and allocate what
    one launch needs (``kernel_inputs``, the outputs, the scratch).  Builds
    nothing: the launch loads the shape's library."""
    tensors = kernel_inputs(derivs, mult_val, mult_jac, mu, levels, second_order)
    B, T = derivs.lx.shape[0], derivs.lx.shape[1]
    n, m, e = derivs.lx.shape[-1], derivs.lu.shape[-1], derivs.eq.shape[-1]
    L = levels.shape[0]
    kw = dict(dtype=mu.dtype, device=mu.device)
    order = _INPUTS + _INPUTS_SECOND_ORDER + ("mu", "levels", "lfx", "lfxx")
    # per-level gains, chosen from at the end; one level writes the outputs
    scratch = (
        torch.empty((L * B * T * m if L > 1 else 0,), **kw),
        torch.empty((L * B * T * m * n if L > 1 else 0,), **kw),
    )
    outputs = (
        torch.empty((B, T, m), **kw), torch.empty((B, T, m, n), **kw),
        torch.empty((B,), dtype=torch.bool, device=mu.device), torch.empty((B,), **kw),
    )  # fmt: skip
    ints = (int(mu.dtype == torch.float64), int(second_order), n, m, e, T, B, L)
    return LaunchPlan(ints, tuple(tensors.get(k) for k in order), scratch, outputs)


def launch_plan(plan: LaunchPlan):
    """Launch the kernel once on ``plan``.  Returns its output tensors
    (k [B, T, m], K [B, T, m, n], ok [B], reg_used [B])."""
    global LAUNCHES, LAUNCHES_SECOND_ORDER, LEVELS_SWEPT
    ptrs = (ctypes.c_void_p * len(plan.inputs))(
        *[0 if x is None else x.data_ptr() for x in plan.inputs]
    )
    _, second_order, n, m, e, _, _, L = plan.ints
    fn = _kernel_fn(n, m, e, second_order)
    dev = plan.outputs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            *plan.ints, ctypes.cast(ptrs, ctypes.c_void_p),
            *[x.data_ptr() for x in plan.scratch + plan.outputs], stream,
        )  # fmt: skip
    if rc == -3:
        raise RuntimeError(
            f"riccati_small: {L} levels at {(n, m, e)} need more shared memory a block "
            "than this card allows; use fewer levels"
        )
    if rc == -1:
        raise RuntimeError(f"riccati_small: the library loaded for {(n, m, e)} serves another shape")
    if rc != 0:
        raise RuntimeError(f"riccati_small kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_SECOND_ORDER += second_order
    LEVELS_SWEPT += L
    return plan.outputs


@functools.lru_cache(maxsize=None)
def _kernel_fn(n, m, e, second_order=False):
    """The C entry point of the library for (n, m, e) and the order, built
    on first use and cached: a launch pays a dict lookup for it."""
    lib = _build.load(SOURCE, instantiation(n, m, e, second_order))
    fn = lib.ddp_riccati_ladder
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    return fn
