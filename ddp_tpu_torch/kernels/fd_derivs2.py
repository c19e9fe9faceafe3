"""Batched SECOND-order forward-dynamics derivatives
(≙ ddp_tpu/kernels/fd_derivs2.py).

Per sample (q, v, τ) of a tree robot with revolute/prismatic joints:
everything ``kernels/fd_derivs.py`` gives, (a, ∂a/∂q, ∂a/∂v, M⁻¹), plus the
acceleration Hessian H[o, i, j] = ∂²a_o/∂ζ_i∂ζ_j over ζ = (q, v, τ), from
differentiating RNEA(q, v, a) = τ implicitly twice against one Cholesky
factor of M:

    M ∂ij a = −[∂ij bias + (∂ij M)·a + (∂i M)(∂j a) + (∂j M)(∂i a)]
    M ∂(τ_k)∂s a = −(∂s M)·(M⁻¹ e_k),         ∂τ∂τ' a = 0

— what the full-DDP derivative pass needs of the dynamics.  ``fd_derivs2``
runs the CUDA kernel ``csrc/fd_derivs2.cu`` on CUDA tensors (from the
library nvcc builds for the joint count at its first call; a primal pass
that runs the chain, factors M and forms a and M⁻¹ once a sample, then one
pass per kind of pair of (q, v) directions, a thread per sample and pair:
the whole chain in hyper-dual numbers for a (q, q) pair, the kinematics in
one tangent and only the RNEA half in hyper-duals for a (q, v) pair, the
kinematics in plain numbers for a (v, v) pair, each solving against the
primal pass's factor) and the plain PyTorch version ``fd_derivs2_reference``
on CPU tensors.  The plain version follows the kernel's algorithm: nested
forward-mode tangents through the same chain, the same right-hand sides
solved against the same unrolled Cholesky, both triangles of H written from
one value.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.func import jvp, vmap

from ddp_tpu_torch.kernels import _build
from ddp_tpu_torch.kernels.fd_derivs import (
    _chain_M_bias,
    _model_constants,
    check_launch,
    check_model,
    instantiation,
    pack_inputs,
    unpack_outputs,
)
from ddp_tpu_torch.kernels.riccati_small import _chol_solve

SOURCE = "fd_derivs2.cu"
# kernel calls since import (or since a caller reset it); each launches the
# primal pass and the three pair passes
LAUNCHES = 0


def unpack_hessian(H_t: torch.Tensor, nv: int) -> torch.Tensor:
    """The kernel's [nv·NZ·NZ, N] output (row (o·NZ + i)·NZ + j, NZ = 3·nv)
    → H [N, nv, NZ, NZ]."""
    NZ = 3 * nv
    return H_t.T.reshape(H_t.shape[1], nv, NZ, NZ)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def fd_derivs2_reference(model, q, v, tau):
    """Plain PyTorch version of the kernel on [N, nv] tensors.  Returns
    (a [N, nv], ∂a/∂q, ∂a/∂v, M⁻¹ each [N, nv, nv], H [N, nv, NZ, NZ])."""
    nv = check_model(model)
    NC, NZ = 2 * nv, 3 * nv
    N = q.shape[0]
    kw = dict(dtype=q.dtype, device=q.device)
    eye = torch.eye(NC, **kw)

    def tangents(e):
        return e[:nv].expand(N, nv), e[nv:].expand(N, nv)

    def first(q_, v_):
        """Primal (M, bias) and their tangents along every (q, v) direction."""

        def one_direction(e):
            return jvp(lambda a_, b_: _chain_M_bias(model, a_, b_), (q_, v_), tangents(e))

        (Ms, biases), (dM, dbias) = vmap(one_direction)(eye)
        return Ms[0], biases[0], dM, dbias

    # row i of the second derivatives: ∂_i of the first-order tangents
    d2M, d2bias = [], []
    for i in range(NC):
        (M, bias, dM, dbias), (_, _, d2M_i, d2bias_i) = jvp(first, (q, v), tangents(eye[i]))
        d2M.append(d2M_i)
        d2bias.append(d2bias_i)

    a = _chol_solve(M, (tau - bias)[..., None], 0.0)[0][..., 0]
    # first order: ∂_c a = −M⁻¹(∂_c bias + (∂_c M)·a), and the columns of M⁻¹
    rhs = -(dbias + torch.einsum("cnij,nj->cni", dM, a)).permute(1, 2, 0)
    unit = torch.eye(nv, **kw).expand(N, nv, nv)
    sol = _chol_solve(M, torch.cat([rhs, unit], dim=-1), 0.0)[0]
    da, Minv = sol[..., :NC], sol[..., NC:]  # da[n, :, c] = ∂_c a

    # (q, v) × (q, v): one solve per pair i ≤ j, written to both triangles
    pairs = [(i, j) for i in range(NC) for j in range(i, NC)]
    cols = []
    for i, j in pairs:
        acc = d2bias[i][j] + torch.einsum("nrc,nc->nr", d2M[i][j], a)
        acc = acc + torch.einsum("nrc,nc->nr", dM[i], da[..., j])
        acc = acc + torch.einsum("nrc,nc->nr", dM[j], da[..., i])
        cols.append(-acc)
    hsol = _chol_solve(M, torch.stack(cols, dim=-1), 0.0)[0]  # [N, nv, pairs]
    H = torch.zeros(N, nv, NZ, NZ, **kw)  # the ττ block stays exactly zero
    for p, (i, j) in enumerate(pairs):
        H[:, :, i, j] = hsol[..., p]
        H[:, :, j, i] = hsol[..., p]
    # τ cross block: −M⁻¹(∂_s M)M⁻¹e_k for s over q; M does not depend on v
    cross = -torch.einsum("snrc,nck->nrsk", dM[:nv], Minv).reshape(N, nv, nv * nv)
    csol = _chol_solve(M, cross, 0.0)[0].reshape(N, nv, nv, nv)  # [n, o, s, k]
    H[:, :, :nv, NC:] = csol
    H[:, :, NC:, :nv] = csol.transpose(-1, -2)
    return a, sol[..., :nv], sol[..., nv:NC], Minv, H


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def fd_derivs2(model, q, v, tau):
    """Batched (a, ∂a/∂q, ∂a/∂v, M⁻¹, H) for [N, nv] inputs, any N: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  H is
    [N, nv, NZ, NZ] with NZ = 3·nv over ζ = (q, v, τ): the full symmetric
    acceleration Hessian, its ττ block exactly zero."""
    check_model(model)
    if q.device.type == "cpu":
        return fd_derivs2_reference(model, q, v, tau)
    return _launch(model, q, v, tau)


def _launch(model, q, v, tau):
    global LAUNCHES
    nv = check_launch(model, q, v, tau)
    N, dtype, dev = q.shape[0], q.dtype, q.device
    a_t = torch.empty((nv, N), dtype=dtype, device=dev)
    Aq_t, Av_t, Mi_t = (torch.empty((nv * nv, N), dtype=dtype, device=dev) for _ in range(3))
    H_t = torch.empty((nv * 9 * nv * nv, N), dtype=dtype, device=dev)
    L_t = torch.empty((nv * (nv + 1) // 2, N), dtype=dtype, device=dev)  # factor of M
    if N == 0:  # nothing to launch, and nothing to count
        return (*unpack_outputs(a_t, Aq_t, Av_t, Mi_t), unpack_hessian(H_t, nv))
    fn = _kernel_fn(nv)
    topo, consts = _model_constants(model, dtype, dev)
    qvu = pack_inputs(q, v, tau)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            int(dtype == torch.float64), nv, N, topo.data_ptr(), consts.data_ptr(),
            qvu.data_ptr(), a_t.data_ptr(), Aq_t.data_ptr(), Av_t.data_ptr(),
            Mi_t.data_ptr(), L_t.data_ptr(), H_t.data_ptr(), stream,
        )  # fmt: skip
    if rc != 0:
        raise RuntimeError(f"fd_derivs2 kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return (*unpack_outputs(a_t, Aq_t, Av_t, Mi_t), unpack_hessian(H_t, nv))


@functools.lru_cache(maxsize=None)
def _kernel_fn(nv):
    """The C entry point of the library for ``nv`` joints, built on first
    use and cached: a launch pays a dict lookup for it."""
    lib = _build.load(SOURCE, instantiation(nv))
    fn = lib.ddp_fd_derivs2
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
    fn.restype = ctypes.c_int
    return fn
