"""Derivative self-verification and NaN guarding
(≙ ddp_tpu/diagnostics/checks.py).

≙ the reference's debug-build Taylor check of its derivatives, here an
opt-in utility with float64 as the oracle, and its NaN asserts: an eager
``assert_finite`` over a pytree and ``nan_debug_mode``, a dispatch mode that
raises where an operation makes a NaN from inputs that had none (the
counterpart of JAX's ``jax_debug_nans``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ddp_tpu_torch.models.base import state_difference, state_integrate


class DerivCheckReport(NamedTuple):
    f_first_order: torch.Tensor  # max over t of ‖df − fx dx − fu du‖/‖df‖
    f_second_order: torch.Tensor  # max over t of residual after Hessian terms
    eq_first_order: torch.Tensor
    l_first_order: torch.Tensor
    ok: torch.Tensor


def check_derivatives(
    problem, xs, us, eps: float = 1e-6, generator: torch.Generator | None = None
) -> DerivCheckReport:
    """Taylor-verify the derivative engine along one trajectory (xs [T+1, nx],
    us [T, nu]).

    For random tangent perturbations of size eps (drawn from ``generator``,
    seeded 0 on the trajectory's device by default), first-order residuals
    must be O(eps²) and (with second_order) the Hessian-corrected residual
    O(eps³)."""
    if generator is None:
        generator = torch.Generator(device=xs.device).manual_seed(0)
    d = problem.derivatives(xs[None], us[None])
    d = type(d)(*(x[0] for x in d))
    model = problem.model
    T = problem.horizon
    kw = dict(dtype=xs.dtype, device=xs.device)
    dxs = eps * torch.randn((T, problem.ndx), generator=generator, **kw)
    dus = eps * torch.randn((T, problem.nu), generator=generator, **kw)
    mask = torch.as_tensor(problem.eq_mask(), **kw)
    tiny = torch.tensor(1e-30, **kw)

    r1, r2, req, rl = [], [], [], []
    for t in range(T):
        x, u, dx, du = xs[t], us[t], dxs[t], dus[t]
        xp = state_integrate(model, x, dx)
        up = u + du
        df = state_difference(model, problem.f(t, x, u), problem.f(t, xp, up))
        lin = d.fx[t] @ dx + d.fu[t] @ du
        quad = 0.5 * (
            torch.einsum("oij,i,j->o", d.fxx[t], dx, dx)
            + 2.0 * torch.einsum("oij,i,j->o", d.fux[t], du, dx)
            + torch.einsum("oij,i,j->o", d.fuu[t], du, du)
        )
        nf = torch.maximum(torch.linalg.norm(df), tiny)
        r1.append(torch.linalg.norm(df - lin) / nf)
        r2.append(torch.linalg.norm(df - lin - quad) / nf)
        deq = (problem.eq(t, xp, up) - problem.eq(t, x, u)) * mask[t]
        req.append(
            torch.linalg.norm(deq - (d.eqx[t] @ dx + d.equ[t] @ du))
            / torch.maximum(torch.linalg.norm(deq), tiny)
        )
        dl = problem.l(t, xp, up) - problem.l(t, x, u)
        rl.append(torch.abs(dl - d.lx[t] @ dx - d.lu[t] @ du) / torch.maximum(torch.abs(dl), tiny))
    r1, r2, req, rl = (torch.stack(r).max() for r in (r1, r2, req, rl))
    return DerivCheckReport(
        f_first_order=r1,
        f_second_order=r2,
        eq_first_order=req,
        l_first_order=rl,
        ok=r1 < torch.tensor(100.0 * eps, **kw),
    )


def assert_finite(tree, name: str = "tree") -> None:
    """Eager NaN/Inf guard over a pytree of tensors (≙ the reference's
    pervasive hasNaN asserts); raises ``FloatingPointError`` naming the
    first leaf that is not finite."""
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        if leaf is not None and not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            raise FloatingPointError(f"non-finite values in {name}{pytree.keystr(path)}")


def _has_nan(tree) -> bool:
    return any(
        isinstance(x, torch.Tensor)
        and (x.is_floating_point() or x.is_complex())
        and bool(torch.isnan(x).any())
        for x in pytree.tree_leaves(tree)
    )


class _NanTrap(TorchDispatchMode):
    """Raises ``FloatingPointError`` where an operation's output holds a NaN
    and none of its inputs did."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _has_nan(out) and not _has_nan((args, kwargs)):
            raise FloatingPointError(f"NaN produced by {func}")
        return out


_TRAP: _NanTrap | None = None


def nan_debug_mode(enable: bool = True) -> None:
    """Globally trap NaN production (the sanitizer-mode analog of JAX's
    ``jax_debug_nans``), on or off for the whole process."""
    global _TRAP
    if enable and _TRAP is None:
        _TRAP = _NanTrap()
        _TRAP.__enter__()
    elif not enable and _TRAP is not None:
        _TRAP.__exit__(None, None, None)
        _TRAP = None
