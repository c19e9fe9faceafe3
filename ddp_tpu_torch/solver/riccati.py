"""Cholesky factor-and-solve for the Riccati sweeps
(≙ ddp_tpu/solver/riccati.py::factor_solve).  The while-loop
``backward_pass`` is part of ROADMAP slice D."""

from __future__ import annotations

import torch


def factor_solve(A: torch.Tensor, *rhs: torch.Tensor):
    """Cholesky-factor the batch of matrices A [..., m, m] and solve
    A·x = −rhs for each rhs ([..., m] or [..., m, c]).

    Returns (ok [...], x1, x2, ...).  A batch element whose factorization
    fails gets NaN solutions and ok = False, as ``jnp.linalg.cholesky``'s NaN
    on non-PD input does — the solvers' ``isfinite`` guards rely on it.
    bf16 inputs factor in f32 and are cast back."""
    dtype = A.dtype
    fdtype = torch.float32 if dtype == torch.bfloat16 else dtype
    chol, info = torch.linalg.cholesky_ex(A.to(fdtype))
    ok = (info == 0) & torch.isfinite(chol).all(dim=(-2, -1))
    outs = []
    for r in rhs:
        vec = r.dim() == A.dim() - 1
        rr = r.to(fdtype)[..., None] if vec else r.to(fdtype)
        x = -torch.cholesky_solve(rr, chol)
        x = torch.where(ok.reshape(ok.shape + (1, 1)), x, torch.nan)
        outs.append((x[..., 0] if vec else x).to(dtype))
    return (ok,) + tuple(outs)
