"""Batched small-dimension Riccati backward sweep, batch-last layout
(≙ ddp_tpu/kernels/riccati_small.py).

Every per-step array is [T, rows, B] with matrices flattened row-major into
the middle axis (``pack_batch_last``).  ``backward_sweep`` runs the CUDA
kernel ``csrc/riccati_small.cu`` on CUDA tensors — one thread per lane, the
whole reverse T loop in the thread — and the plain PyTorch version
``backward_sweep_reference`` on CPU tensors.  AL multiplier terms throughout;
with the six rank-3 slabs ``fxx … equu`` in the packed dict (full DDP) the
Q-expansion gains ``Vx·fxx + tmp·eqxx`` and its ux/uu counterparts, without
them it is the Gauss-Newton form.
"""

from __future__ import annotations

import ctypes

import torch

from ddp_tpu_torch.kernels import _build

SOURCE = "riccati_small.cu"
# (n, m, e) the CUDA source instantiates: the pendulum headline, UR5 with a
# configuration target, panda7 with a frame target
KERNEL_DIMS = ((2, 1, 1), (12, 6, 6), (14, 7, 3))
# … and with the second-order terms: pendulum, cartpole/acrobot with a
# configuration target, panda7 with a frame target
KERNEL_DIMS_SECOND_ORDER = ((2, 1, 1), (4, 2, 2), (14, 7, 3))
# kernel launches since import (or since a caller reset it), and how many
# of them ran the second-order instantiation
LAUNCHES = 0
LAUNCHES_SECOND_ORDER = 0

_INPUTS = (
    "lx", "lu", "lxx", "lux", "luu", "fx", "fu",
    "eq", "eqx", "equ", "pe", "pex",
)  # fmt: skip
# the rank-3 slabs of a full-DDP sweep, row index (o·r + i)·c + j
_INPUTS_SECOND_ORDER = ("fxx", "fux", "fuu", "eqxx", "equx", "equu")


def pack_batch_last(derivs, mult_val, mult_jac, second_order: bool = False):
    """Batch-major Derivs ([B, T, …]) → the kernel's dict of [T, rows, B]
    arrays, plus the terminal lfx [n, B] and lfxx [n*n, B].  With
    ``second_order`` the six rank-3 tensor blocks ride along for the full-DDP
    sweep."""

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
    """Plain PyTorch version of the kernel: the same inputs and outputs,
    batched tensor ops over the lanes of each [rows, B] slab; the
    second-order terms are added when ``derivs_bl`` holds the rank-3 slabs.

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


def backward_sweep(derivs_bl: dict, mu, reg, *, T, n, m, e):
    """Riccati backward sweep over the whole batch: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    ``derivs_bl`` is ``pack_batch_last``'s dict, with or without the
    second-order slabs; mu, reg are [B].
    Returns (k [T, m, B], K [T, m*n, B], ok [B] bool)."""
    if derivs_bl["lx"].device.type == "cpu":
        return backward_sweep_reference(derivs_bl, mu, reg, T=T, n=n, m=m, e=e)
    return _launch(derivs_bl, mu, reg, T=T, n=n, m=m, e=e)


def _launch(d, mu, reg, *, T, n, m, e):
    global LAUNCHES, LAUNCHES_SECOND_ORDER
    second_order = "fxx" in d
    have = KERNEL_DIMS_SECOND_ORDER if second_order else KERNEL_DIMS
    if (n, m, e) not in have:
        raise ValueError(
            f"no CUDA instantiation for (n, m, e)={(n, m, e)}"
            f"{' with second-order terms' if second_order else ''}; have {have}"
        )
    lx = d["lx"]
    B, dtype, dev = lx.shape[-1], lx.dtype, lx.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    rows = _rows(n, m, e, second_order)
    expected = {k: (T, r, B) for k, r in rows.items()}
    expected.update(lfx=(n, B), lfxx=(n * n, B))
    tensors = {k: d[k] for k in expected}
    tensors.update(mu=mu, reg=reg)
    expected.update(mu=(B,), reg=(B,))
    for k, x in tensors.items():
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{k}: {x.dtype} on {x.device}, expected {dtype} on {dev}")
        if tuple(x.shape) != expected[k]:
            raise ValueError(f"{k}: shape {tuple(x.shape)}, expected {expected[k]}")
        if not x.is_contiguous():
            raise ValueError(f"{k} must be contiguous")

    fn = _kernel_fn()
    order = _INPUTS + ("mu", "reg", "lfx", "lfxx")
    if second_order:
        order += _INPUTS_SECOND_ORDER
    ptrs = (ctypes.c_void_p * len(order))(*[tensors[k].data_ptr() for k in order])
    k_out = torch.empty((T, m, B), dtype=dtype, device=dev)
    K_out = torch.empty((T, m * n, B), dtype=dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            int(dtype == torch.float64), int(second_order), n, m, e, T, B,
            ctypes.cast(ptrs, ctypes.c_void_p),
            k_out.data_ptr(), K_out.data_ptr(), ok.data_ptr(), stream,
        )  # fmt: skip
    if rc != 0:
        raise RuntimeError(f"riccati_small kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_SECOND_ORDER += int(second_order)
    return k_out, K_out, ok


def _kernel_fn():
    lib = _build.load(SOURCE)
    fn = lib.ddp_riccati_small_bwd
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn
