"""The port's second-order fd-derivatives module
(ddp_tpu_torch/kernels/fd_derivs2.py) on the CPU, f64: its plain version —
the arithmetic the CUDA kernel repeats — against the Pallas kernel in
interpret mode and against ``jacfwd∘jacfwd`` of the port's own
``forward_dynamics``, plus the wrapper's gates and layout.

Bars: (a, ∂a/∂q, ∂a/∂v, M⁻¹) 1e-9 and H 1e-8, absolute, against the Pallas
kernel (tests/test_fd_derivs2_kernel.py's); against the jacfwd oracle the
same bars relative to each array's largest entry (M⁻¹ of the arm reaches
1e3 and H 1e5).  H is symmetric and its ττ block zero with ``atol=0``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap
from torch_parity_helpers import both_robots, branched_tree, t

from ddp_tpu.kernels.fd_derivs2 import fd_derivs2_pallas
from ddp_tpu.models import robots as jrobots
from ddp_tpu.models.rigid_body import build_model as jbuild_model
from ddp_tpu_torch.kernels import fd_derivs as fd
from ddp_tpu_torch.kernels import fd_derivs2 as fd2

jax.config.update("jax_enable_x64", True)

OUTPUTS = ("a", "da_dq", "da_dv", "Minv", "H")
BARS = (1e-9, 1e-9, 1e-9, 1e-9, 1e-8)


def inputs(nv, N, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((N, nv)) for _ in range(3))


# --------------------------------------------- against the TPU kernel itself


@pytest.fixture(scope="module", params=["cartpole", "acrobot"])
def pallas_case(request):
    """The Pallas kernel in interpret mode and the port's plain version on
    the same 128 samples (one lane block)."""
    jm, tm = both_robots(getattr(jrobots, request.param)(dtype=jnp.float64))
    q, v, tau = inputs(jm.nv, 128)
    ref = fd_derivs2_pallas(
        jm, jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau), block_b=128, interpret=True
    )
    got = fd2.fd_derivs2_reference(tm, t(q), t(v), t(tau))
    return tm, (q, v, tau), ref, got


@pytest.mark.parametrize("k", range(5), ids=OUTPUTS)
def test_reference_matches_pallas_interpret(pallas_case, k):
    *_, ref, got = pallas_case
    assert tuple(got[k].shape) == ref[k].shape
    np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=BARS[k])


def test_first_order_outputs_are_fd_derivs(pallas_case):
    """(a, ∂a/∂q, ∂a/∂v, M⁻¹) are the first-order module's, to roundoff."""
    tm, (q, v, tau), _, got = pallas_case
    for g, r in zip(got[:4], fd.fd_derivs_reference(tm, t(q), t(v), t(tau))):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-11)


def test_wrapper_on_cpu_is_the_plain_version(pallas_case):
    tm, (q, v, tau), _, got = pallas_case
    before = fd2.LAUNCHES
    out = fd2.fd_derivs2(tm, t(q), t(v), t(tau))
    assert fd2.LAUNCHES == before  # no kernel was launched for CPU tensors
    for g, r in zip(out, got):
        assert torch.equal(g, r)


# ------------------------------------- against jacfwd∘jacfwd of the port's FD

ORACLE_MODELS = {"panda7": jrobots.panda7, "branched": branched_tree}


@pytest.fixture(scope="module", params=sorted(ORACLE_MODELS))
def oracle_case(request):
    """panda7 and the branched six-joint tree (parent ≠ i − 1, prismatic
    joints, structural zeros in M), with damping."""
    import dataclasses

    jm = ORACLE_MODELS[request.param](dtype=jnp.float64)
    rng = np.random.default_rng(2)
    jm = dataclasses.replace(jm, damping=jnp.asarray(rng.uniform(0, 0.2, jm.nv)))
    _, tm = both_robots(jm)
    nv, N = tm.nv, 3
    q, v, tau = (t(x) for x in inputs(nv, N, seed=3))
    got = fd2.fd_derivs2_reference(tm, q, v, tau)

    def a_fn(z):
        return tm.forward_dynamics(z[:nv], z[nv : 2 * nv], z[2 * nv :])

    z = torch.cat([q, v, tau], dim=1)
    J = vmap(jacfwd(a_fn))(z)
    ref = (vmap(a_fn)(z), J[..., :nv], J[..., nv : 2 * nv], J[..., 2 * nv :],
           vmap(jacfwd(jacfwd(a_fn)))(z))  # fmt: skip
    return nv, ref, got


@pytest.mark.parametrize("k", range(5), ids=OUTPUTS)
def test_reference_matches_jacfwd_of_forward_dynamics(oracle_case, k):
    _, ref, got = oracle_case
    assert got[k].shape == ref[k].shape
    scale = max(1.0, float(ref[k].abs().max()))
    np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=BARS[k] * scale)


def check_hessian_structure(H):
    """Both triangles of H come from one value, the ττ block is exactly zero
    (a is affine in τ), and so is the v×τ block (M does not depend on v)."""
    nv = H.shape[1]
    assert float(H.abs().max()) > 1.0
    np.testing.assert_allclose(H.numpy(), H.transpose(-1, -2).numpy(), rtol=0, atol=0)
    assert float(H[:, :, 2 * nv :, 2 * nv :].abs().max()) == 0.0
    assert float(H[:, :, nv : 2 * nv, 2 * nv :].abs().max()) == 0.0
    assert float(H[:, :, :nv, 2 * nv :].abs().max()) > 0.0  # the q×τ block is not


def test_hessian_symmetric_and_tau_tau_zero(pallas_case):
    check_hessian_structure(pallas_case[-1][4])


def test_hessian_symmetric_and_tau_tau_zero_arm_and_tree(oracle_case):
    check_hessian_structure(oracle_case[-1][4])


# ----------------------------------------------------------- gates, layout


def test_rejects_quaternion_models():
    _, tm = both_robots(jrobots.quadrotor(dtype=jnp.float64))
    x = torch.zeros(2, tm.nv, dtype=torch.float64)
    q = tm.neutral_configuration().expand(2, tm.nq)
    for fn in (fd2.fd_derivs2, fd2.fd_derivs2_reference):
        with pytest.raises(ValueError, match="revolute/prismatic"):
            fn(tm, q, x, x)


def test_launch_gates_raise_before_any_build():
    """Joint counts, dtypes and shapes the kernel does not take raise."""
    _, three = both_robots(
        jbuild_model([dict(type="revolute", parent=i - 1) for i in range(3)], dtype=jnp.float64)
    )
    x3 = torch.zeros(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match=r"no CUDA instantiation for nv=3"):
        fd2._launch(three, x3, x3, x3)
    _, two = both_robots(jrobots.cartpole(dtype=jnp.float64))
    x2 = torch.zeros(4, 2, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or float64"):
        fd2._launch(two, x2.half(), x2.half(), x2.half())
    with pytest.raises(ValueError, match="shape"):
        fd2._launch(two, x2, x2[:3], x2)
    with pytest.raises(ValueError, match="expected torch.float64"):
        fd2._launch(two, x2, x2.float(), x2)


def test_empty_batch_launches_nothing():
    """N = 0 returns empty outputs of the right shapes without a launch (and
    without a build: this runs where there is no compiler)."""
    _, tm = both_robots(jrobots.cartpole(dtype=jnp.float64))
    x = torch.zeros(0, 2, dtype=torch.float64)
    before = fd2.LAUNCHES
    a, A, Bv, Mi, H = fd2._launch(tm, x, x, x)
    assert fd2.LAUNCHES == before
    assert a.shape == (0, 2) and A.shape == Bv.shape == Mi.shape == (0, 2, 2)
    assert H.shape == (0, 2, 6, 6)


def test_hessian_unpacking_follows_the_kernels_rows():
    """Row (o·NZ + i)·NZ + j of the kernel's sample-last output is
    H[n, o, i, j]."""
    rng = np.random.default_rng(9)
    N, nv = 5, 2
    NZ = 3 * nv
    H = t(rng.normal(size=(N, nv, NZ, NZ)))
    H_t = H.reshape(N, nv * NZ * NZ).T.contiguous()
    assert torch.equal(fd2.unpack_hessian(H_t, nv), H)
    assert float(H_t[(1 * NZ + 4) * NZ + 2, 3]) == float(H[3, 1, 4, 2])
