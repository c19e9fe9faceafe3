"""Riccati backward pass with augmented-Lagrangian terms
(≙ ddp_tpu/solver/riccati.py).

``backward_sweep`` is one sweep over a batch of trajectories (leading dim);
``backward_pass`` is the pass of ``solve`` and ``solve_vmap``: the sweep, and
while a trajectory's factorization fails the reference's restart with
reg = 2·max(reg, μ) and μ doubled for that trajectory, at most
``max_retries`` times.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddp_tpu_torch.solver import al as al_mod


class BackwardResult(NamedTuple):
    k: torch.Tensor  # [T, nu]        feedforward gain
    K: torch.Tensor  # [T, nu, ndx]   feedback gain
    mu: torch.Tensor  # possibly-escalated AL penalty
    reg: torch.Tensor  # possibly-escalated regularization
    ok: torch.Tensor  # bool: the final sweep factorized everywhere
    dV: torch.Tensor  # expected cost decrease Σ kᵀQu (diagnostic)


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


def backward_sweep(derivs, mult_val, mult_jac, mu, reg, with_dV: bool = False):
    """One Riccati sweep (no retry) over trajectories with any leading batch
    dims, none for a single one: ``derivs`` [..., T, …], ``mult_val``
    [..., T, ne], ``mult_jac`` [..., T, ne, ndx], μ and reg [...].  Returns
    (k [..., T, nu], K [..., T, nu, ndx], ok [...], dV [...] or None),
    dV = Σ_t k_tᵀ Qu_t only ``with_dV``.  Without batch dims every product
    is a 2-D one, which on the CPU gives the same bits as ``ddp_tpu``'s
    (batched products round differently)."""
    tmv = al_mod.tmv

    def contract(v, H):  # einsum("o,oij->ij") per trajectory
        return torch.einsum("...o,...oij->...ij", v, H)

    d = derivs
    T, nu = d.lu.shape[-2], d.lu.shape[-1]
    I_u = torch.eye(nu, dtype=d.lx.dtype, device=d.lx.device)
    mu1, mu2 = mu[..., None], mu[..., None, None]
    Vx, Vxx = d.lfx, d.lfxx
    ks, Ks, dVs = [None] * T, [None] * T, [None] * T
    ok = torch.ones(mu.shape, dtype=torch.bool, device=mu.device)
    for t in reversed(range(T)):
        fx, fu, eqv = d.fx[..., t, :, :], d.fu[..., t, :, :], d.eq[..., t, :]
        eqx, equ = d.eqx[..., t, :, :], d.equ[..., t, :, :]
        pe, pex = mult_val[..., t, :], mult_jac[..., t, :, :]
        tmp = pe + mu1 * eqv
        tmp2 = pex + mu2 * eqx
        Qx = d.lx[..., t, :] + tmv(fx, Vx) + tmv(eqx, tmp) + tmv(pex, eqv)
        Qu = d.lu[..., t, :] + tmv(fu, Vx) + tmv(equ, tmp)
        Qxx = (
            d.lxx[..., t, :, :] + fx.mT @ Vxx @ fx + eqx.mT @ tmp2 + pex.mT @ eqx
            + contract(tmp, d.eqxx[..., t, :, :, :]) + contract(Vx, d.fxx[..., t, :, :, :])
        )  # fmt: skip
        Quu = (
            d.luu[..., t, :, :] + fu.mT @ Vxx @ fu + mu2 * equ.mT @ equ
            + contract(tmp, d.equu[..., t, :, :, :]) + contract(Vx, d.fuu[..., t, :, :, :])
        )  # fmt: skip
        Qux = (
            d.lux[..., t, :, :] + fu.mT @ Vxx @ fx + equ.mT @ tmp2
            + contract(tmp, d.equx[..., t, :, :, :]) + contract(Vx, d.fux[..., t, :, :, :])
        )  # fmt: skip
        ok_t, k, K = factor_solve(Quu + reg[..., None, None] * I_u, Qu, Qux)
        Vx = Qx + tmv(Qux, k)
        Vxx = Qxx + Qux.mT @ K
        ks[t], Ks[t] = k, K
        if with_dV:
            dVs[t] = (k[..., None, :] @ Qu[..., :, None])[..., 0, 0]
        ok = ok & ok_t
    dV = torch.stack(dVs, dim=-1).sum(dim=-1) if with_dV else None
    return torch.stack(ks, dim=-2), torch.stack(Ks, dim=-3), ok, dV


@al_mod.full_fp32_matmuls()
def backward_pass(derivs, mult_val, mult_jac, mu, reg, max_retries: int = 24,
                  live=None) -> BackwardResult:  # fmt: skip
    """The sweep on trajectories with any leading batch dims, none for one
    (``derivs`` [..., T, …], ``mult_val`` [..., T, ne], ``mult_jac``
    [..., T, ne, ndx], μ and reg [...]) and, while a trajectory's
    factorization fails, the sweep again at its reg = 2·max(reg, μ) and 2μ,
    at most ``max_retries`` times (≙ ``jax.vmap`` of ddp_tpu's retry loop: a
    trajectory that factorized keeps its sweep).  Returns the last sweep's
    gains and the μ and reg it ran at.  A trajectory outside the bool mask
    ``live`` [...] does not retry: its result is the caller's to discard."""

    k, K, ok, dV = backward_sweep(derivs, mult_val, mult_jac, mu, reg, with_dV=True)
    retry = ~ok if live is None else ~ok & live
    it = 0
    while bool(retry.any()) and it < max_retries:
        reg = torch.where(retry, torch.maximum(reg, mu) * 2.0, reg)
        mu = torch.where(retry, mu * 2.0, mu)
        k2, K2, ok2, dV2 = backward_sweep(derivs, mult_val, mult_jac, mu, reg, with_dV=True)
        k = torch.where(retry[..., None, None], k2, k)
        K = torch.where(retry[..., None, None, None], K2, K)
        ok, dV = torch.where(retry, ok2, ok), torch.where(retry, dV2, dV)
        retry = retry & ~ok
        it += 1
    return BackwardResult(k=k, K=K, mu=mu, reg=reg, ok=ok, dV=dV)
