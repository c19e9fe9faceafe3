"""Parallel (associative-scan) Riccati backward pass, O(log T) depth
(≙ ddp_tpu/solver/parallel_riccati.py).

For the Gauss-Newton path (no dynamics Hessians) the Riccati recursion is an
associative operation on conditional value-function elements, so the whole
sweep parallelizes over time.  Each step contributes an element
e_t = (A, b, C, η, J); composition (e₁ earlier in time) is

    A = A₂(I + C₁J₂)⁻¹A₁
    b = A₂(I + C₁J₂)⁻¹(b₁ + C₁η₂) + b₂
    C = A₂(I + C₁J₂)⁻¹C₁A₂ᵀ + C₂
    η = A₁ᵀ(I + J₂C₁)⁻¹(η₂ − J₂b₁) + η₁
    J = A₁ᵀ(I + J₂C₁)⁻¹J₂A₁ + J₁

After the reverse scan, element t composed with everything to its right
gives V_t(dx) = ½dxᵀJdx − ηᵀdx, and the gains of every step follow at once.

The scan is written here (``_reverse_scan``: ddp_tpu's odd-even recursion,
2⌈log₂(T+1)⌉ dependent compositions over batch-major elements
[..., T+1, n, n]); PyTorch's own associative scan is a private prototype.
Singular compositions and non-PD blocks give NaN per lane (``solve_ex``,
``cholesky_ex``: no host sync, no raise), and ``ok`` is read from
finiteness as ddp_tpu's is.

Limits, as ddp_tpu's: exact for Gauss-Newton only (``second_order`` couples V
into the elements); reg is folded into the control cost as reg·I, identical
to the sequential sweep at reg = 0.  Unlike ddp_tpu's, which inherits the
caller's matmul precision, the products run in full float32 on the card
(``al.full_fp32_matmuls``), as the port's sequential sweep does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddp_tpu_torch.solver import al as al_mod
from ddp_tpu_torch.solver.riccati import factor_solve

mv, tmv = al_mod.mv, al_mod.tmv


class _Elem(NamedTuple):
    A: torch.Tensor  # [..., N, n, n]
    b: torch.Tensor  # [..., N, n]
    C: torch.Tensor  # [..., N, n, n]
    eta: torch.Tensor  # [..., N, n]
    J: torch.Tensor  # [..., N, n, n]


def _compose(e1: _Elem, e2: _Elem) -> _Elem:
    """e1 ⊗ e2 (e1 earlier in time), elementwise over the leading dims."""
    n = e1.A.shape[-1]
    I = torch.eye(n, dtype=e1.A.dtype, device=e1.A.device)
    M = I + e1.C @ e2.J  # (I + C₁J₂)
    A2M = e2.A @ torch.linalg.solve_ex(M, I.expand_as(M))[0]
    A = A2M @ e1.A
    b = mv(A2M, e1.b + mv(e1.C, e2.eta)) + e2.b
    C = A2M @ e1.C @ e2.A.mT + e2.C
    Mt = I + e2.J @ e1.C
    A1Mt = e1.A.mT @ torch.linalg.solve_ex(Mt, I.expand_as(Mt))[0]
    eta = mv(A1Mt, e2.eta - mv(e2.J, e1.b)) + e1.eta
    J = A1Mt @ e2.J @ e1.A + e1.J
    return _Elem(A, b, C, eta, J)


def _sl(x, d, start, stop=None, step=None):
    """x[start:stop:step] along dim d."""
    return x[(slice(None),) * d + (slice(start, stop, step),)]


def _scan(elems: _Elem, fn, d: int) -> _Elem:
    """Inclusive scan along dim d by jax.lax.associative_scan's odd-even
    recursion: fn combines adjacent pairs, the pairs are scanned, and the
    even positions are fixed up by one more fn each."""
    N = elems.b.shape[d]
    if N < 2:
        return elems
    reduced = fn(
        _Elem(*(_sl(x, d, 0, N - 1, 2) for x in elems)),
        _Elem(*(_sl(x, d, 1, None, 2) for x in elems)),
    )
    odd = _scan(reduced, fn, d)
    head = _Elem(*(_sl(o, d, 0, -1) for o in odd)) if N % 2 == 0 else odd
    even = fn(head, _Elem(*(_sl(x, d, 2, None, 2) for x in elems)))
    out = []
    for x, e, o in zip(elems, even, odd):
        e = torch.cat([_sl(x, d, 0, 1), e], dim=d)
        n = o.shape[d]
        both = torch.stack([_sl(e, d, 0, n), o], dim=d + 1).flatten(d, d + 1)
        out.append(torch.cat([both, _sl(e, d, n)], dim=d))
    return _Elem(*out)


def _reverse_scan(elems: _Elem, combine=_compose) -> _Elem:
    """Inclusive reverse scan over the time dim (the one before each vector's
    last): out[t] = e_t ⊗ e_{t+1} ⊗ … ⊗ e_{N−1}, in 2⌈log₂ N⌉ dependent
    compositions.  As ddp_tpu's ``associative_scan(reverse=True)``: the
    forward scan of the time-reversed elements with the operands swapped, so
    pairs form from the terminal end and every fix-up composes one element
    with a suffix that holds the terminal cost.  (Recursive doubling, which
    composes windows of 2ᵈ steps that lack it, left the float32 gains of
    bench.py's T200 row a median 5e-2 and up to 55× their size off the
    float64 ones; this order, 5e-5 and 3e-3, as ddp_tpu's.)"""
    d = elems.b.dim() - 2
    out = _scan(_Elem(*(x.flip(d) for x in elems)), lambda a, b: combine(b, a), d)
    return _Elem(*(x.flip(d) for x in out))


def effective_stage_blocks(derivs, mult_val, mult_jac, mu, reg):
    """Per-step effective LQR blocks with the AL terms folded into the cost,
    the V-independent parts of the Q-expansion, over [..., T]:
    ½dxᵀXdx + gxᵀdx + ½duᵀUdu + guᵀdu + duᵀMdx.  μ and reg are [...].
    Returns (X, gx, U, gu, M)."""
    d = derivs
    nu = d.lu.shape[-1]
    I_u = torch.eye(nu, dtype=d.lu.dtype, device=d.lu.device)
    mu1, mu2 = mu[..., None, None], mu[..., None, None, None]
    tmp = mult_val + mu1 * d.eq
    tmp2 = mult_jac + mu2 * d.eqx
    X = d.lxx + d.eqx.mT @ tmp2 + mult_jac.mT @ d.eqx
    gx = d.lx + tmv(d.eqx, tmp) + tmv(mult_jac, d.eq)
    U = d.luu + mu2 * d.equ.mT @ d.equ + reg[..., None, None, None] * I_u
    gu = d.lu + tmv(d.equ, tmp)
    M = d.lux + d.equ.mT @ tmp2
    return X, gx, U, gu, M


@al_mod.full_fp32_matmuls()
def backward_pass_assoc(derivs, mult_val, mult_jac, mu, reg):
    """Associative-scan Riccati over trajectories with any leading batch dims
    (``derivs`` [..., T, …], μ and reg [...]): returns (k [..., T, nu],
    K [..., T, nu, ndx], ok [...]).  Gauss-Newton only: the dynamics Hessians
    are not read."""
    d = derivs
    X, gx, U, gu, M = effective_stage_blocks(d, mult_val, mult_jac, mu, reg)
    F, L = d.fx, d.fu

    chol_U, info = torch.linalg.cholesky_ex(U)
    ok_U = (info == 0) & torch.isfinite(chol_U).all(dim=(-2, -1))  # [..., T]

    def solve_U(rhs):  # U⁻¹·rhs, NaN where U did not factorize
        x = torch.cholesky_solve(rhs, chol_U)
        return torch.where(ok_U[..., None, None], x, torch.nan)

    Uinv_gu = solve_U(gu[..., None])[..., 0]  # [..., T, nu]
    Uinv_M = solve_U(M)  # [..., T, nu, ndx]
    Uinv_Lt = solve_U(L.mT)  # [..., T, nu, ndx] = U⁻¹Lᵀ

    # per-step elements (drift 0: the linearization is exact at the nominal)
    A = F - L @ Uinv_M
    b = -mv(L, Uinv_gu)
    C = L @ Uinv_Lt
    J = X - M.mT @ Uinv_M
    eta = -(gx - tmv(M, Uinv_gu))

    # terminal element: V_T(dx) = ½dxᵀ lfxx dx + lfxᵀdx
    zero_n = torch.zeros_like(A[..., :1, :, :])
    zero_v = torch.zeros_like(b[..., :1, :])
    elems = _Elem(
        A=torch.cat([A, zero_n], dim=-3),
        b=torch.cat([b, zero_v], dim=-2),
        C=torch.cat([C, zero_n], dim=-3),
        eta=torch.cat([eta, -d.lfx[..., None, :]], dim=-2),
        J=torch.cat([J, d.lfxx[..., None, :, :]], dim=-3),
    )
    combined = _reverse_scan(elems)
    # V_{t+1} from the element composed over [t+1, T]
    S_next = combined.J[..., 1:, :, :]
    s_next = -combined.eta[..., 1:, :]

    Quu = U + L.mT @ S_next @ L
    Qu = gu + tmv(L, s_next)
    Qux = M + L.mT @ S_next @ F
    ok_t, k, K = factor_solve(Quu, Qu, Qux)
    return k, K, ok_U.all(dim=-1) & ok_t.all(dim=-1)
