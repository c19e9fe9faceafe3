"""The port's fd-derivatives kernel module (ddp_tpu_torch/kernels/fd_derivs.py)
on the CPU, f64: its plain version — the arithmetic the CUDA kernel
repeats — against ddp_tpu's ``fd_derivatives`` under ``jax.vmap`` and against
the Pallas kernel in interpret mode, plus the wrapper's gates and packing.

Tolerance 1e-9 of each output array's largest entry (the bar of the JAX
package's own kernel test, tests/test_fd_derivs_kernel.py; M⁻¹ of the arm
reaches 1e3, so the bar is relative)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import both_robots, branched_tree, t

from ddp_tpu.kernels.fd_derivs import fd_derivs_pallas
from ddp_tpu.models import robots as jrobots
from ddp_tpu.models.rigid_body import build_model as jbuild_model
from ddp_tpu_torch.kernels import fd_derivs as fd

jax.config.update("jax_enable_x64", True)

OUTPUTS = ("a", "da_dq", "da_dv", "Minv")


MAKERS = {
    "panda7": jrobots.panda7,
    "cartpole": jrobots.cartpole,
    "acrobot": jrobots.acrobot,
    "branched": branched_tree,
}


def inputs(model, N, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(-np.pi, np.pi, (N, model.nq)),
        rng.normal(size=(N, model.nv)),
        rng.normal(size=(N, model.nv)),
    )


def close(got, ref, tol=1e-9):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max()))
    )


@pytest.fixture(scope="module", params=sorted(MAKERS))
def case(request):
    jm = MAKERS[request.param](dtype=jnp.float64)
    rng = np.random.default_rng(2)
    jm = dataclasses.replace(jm, damping=jnp.asarray(rng.uniform(0, 0.2, jm.nv)))
    jm, tm = both_robots(jm)
    q, v, tau = inputs(jm, 6)
    ref = jax.vmap(jm.fd_derivatives)(q, v, tau)
    got = fd.fd_derivs_reference(tm, t(q), t(v), t(tau))
    return jm, tm, (q, v, tau), ref, got


@pytest.mark.parametrize("k", range(4), ids=OUTPUTS)
def test_reference_matches_jax_fd_derivatives(case, k):
    *_, ref, got = case
    assert got[k].shape == ref[k].shape
    close(got[k], ref[k])


def test_reference_matches_port_model(case):
    """… and the port's own ``RobotModel.fd_derivatives`` (another algorithm:
    world-frame contractions and ``jacfwd`` over RNEA)."""
    _, tm, (q, v, tau), _, got = case
    for g, r in zip(got, tm.fd_derivatives(t(q), t(v), t(tau))):
        close(g, r.numpy())


def test_wrapper_on_cpu_is_the_plain_version(case):
    _, tm, (q, v, tau), _, got = case
    before = fd.LAUNCHES
    out = fd.fd_derivs(tm, t(q), t(v), t(tau))
    assert fd.LAUNCHES == before  # no kernel was launched for CPU tensors
    for g, r in zip(out, got):
        assert torch.equal(g, r)


@pytest.mark.parametrize("k", range(4), ids=OUTPUTS)
def test_reference_matches_pallas_interpret_cartpole(k):
    """Against the TPU kernel itself, in interpret mode (nv = 2 only: the
    arm's interpret-mode compile takes minutes)."""
    jm, tm = both_robots(jrobots.cartpole(dtype=jnp.float64))
    q, v, tau = inputs(jm, 128, seed=4)
    ref = fd_derivs_pallas(jm, jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau),
                           block_b=128, interpret=True)  # fmt: skip
    close(fd.fd_derivs_reference(tm, t(q), t(v), t(tau))[k], ref[k])


def test_rejects_quaternion_models():
    _, tm = both_robots(jrobots.quadrotor(dtype=jnp.float64))
    x = torch.zeros(2, tm.nv, dtype=torch.float64)
    q = tm.neutral_configuration().expand(2, tm.nq)
    for fn in (fd.fd_derivs, fd.fd_derivs_reference):
        with pytest.raises(ValueError, match="revolute/prismatic"):
            fn(tm, q, x, x)


def test_launch_gates_raise_before_any_build():
    """Joint counts, dtypes and shapes the kernel does not take raise."""
    _, three = both_robots(
        jbuild_model([dict(type="revolute", parent=i - 1) for i in range(3)], dtype=jnp.float64)
    )
    x3 = torch.zeros(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match=r"no CUDA instantiation for nv=3"):
        fd._launch(three, x3, x3, x3)
    _, two = both_robots(jrobots.cartpole(dtype=jnp.float64))
    x2 = torch.zeros(4, 2, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or float64"):
        fd._launch(two, x2.half(), x2.half(), x2.half())
    with pytest.raises(ValueError, match="shape"):
        fd._launch(two, x2, x2[:3], x2)
    with pytest.raises(ValueError, match="expected torch.float64"):
        fd._launch(two, x2, x2.float(), x2)


def test_model_constants_are_cached_in_the_kernels_layout():
    """The kernel's view of a model is built once per (device, dtype) and
    reused; ``forget_model`` drops it."""
    jm, tm = both_robots(jrobots.panda7(dtype=jnp.float64))
    nv = tm.nv
    topo, consts = fd._model_constants(tm, torch.float64, torch.device("cpu"))
    again = fd._model_constants(tm, torch.float64, "cpu")
    assert again[0] is topo and again[1] is consts
    assert topo.dtype == torch.int32 and topo.tolist() == [0] * nv + list(jm.parents)
    assert consts.shape == (52 * nv + 3,) and consts.is_contiguous()
    close(consts[: 3 * nv].reshape(nv, 3), jm.axes, 0)
    close(consts[15 * nv : 51 * nv].reshape(nv, 6, 6), jm.inertias, 0)
    close(consts[51 * nv : 51 * nv + 3], jm.gravity, 0)
    close(consts[51 * nv + 3 :], jm.damping, 0)
    single = fd._model_constants(tm, torch.float32, "cpu")[1]
    assert single.dtype == torch.float32 and single is not consts
    fd.forget_model(tm)
    assert fd._model_constants(tm, torch.float64, "cpu")[1] is not consts


def test_empty_batch_launches_nothing():
    """N = 0 returns empty outputs of the right shapes without a launch (and
    without a build: this runs where there is no compiler)."""
    _, tm = both_robots(jrobots.cartpole(dtype=jnp.float64))
    x = torch.zeros(0, 2, dtype=torch.float64)
    before = fd.LAUNCHES
    a, A, Bv, Mi = fd._launch(tm, x, x, x)
    assert fd.LAUNCHES == before
    assert a.shape == (0, 2) and A.shape == Bv.shape == Mi.shape == (0, 2, 2)


def test_packing_round_trip():
    """[N, nv] → the kernel's sample-last rows and back."""
    rng = np.random.default_rng(9)
    N, nv = 5, 3
    q, v, tau = (t(rng.normal(size=(N, nv))) for _ in range(3))
    qvu = fd.pack_inputs(q, v, tau)
    assert qvu.shape == (3 * nv, N) and qvu.is_contiguous()
    assert torch.equal(qvu[:nv].T, q) and torch.equal(qvu[nv : 2 * nv].T, v)
    assert torch.equal(qvu[2 * nv :].T, tau)
    a, A, Bv, Mi = (t(rng.normal(size=s)) for s in ((N, nv), (N, nv, nv), (N, nv, nv), (N, nv, nv)))
    back = fd.unpack_outputs(
        a.T.contiguous(), *(x.reshape(N, nv * nv).T.contiguous() for x in (A, Bv, Mi))
    )
    for g, r in zip(back, (a, A, Bv, Mi)):
        assert torch.equal(g, r)
    # row n·nv + c of the flattened matrices is entry [n, c], as the kernel stores it
    assert float(A.reshape(N, nv * nv).T[1 * nv + 2, 4]) == float(A[4, 1, 2])
