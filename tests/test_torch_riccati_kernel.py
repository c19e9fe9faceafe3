"""ddp_tpu_torch.kernels.riccati_small against ddp_tpu's Riccati backward.

The CUDA kernel itself runs only on a card (``chip_smoke.py`` holds it to
the plain version there); on the CPU the wrapper takes the plain PyTorch
version, which these tests hold to the Pallas kernel in interpret mode and
to the XLA sweep, on the same numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.kernels.riccati_small import backward_sweep_pallas
from ddp_tpu.kernels.riccati_small import pack_batch_last as jax_pack
from ddp_tpu.solver import al as jal
from ddp_tpu.solver.batched import _backward_sweep as jax_backward_sweep
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.ocp.problem import Derivs as TDerivs

from torch_parity_helpers import (
    TORCH_DTYPE,
    jax_pendulum_problem,
    random_spd_derivs,
    t,
    to_jax_derivs,
    to_torch_derivs,
)


def pendulum_batch(B, H, np_dtype, bad_lane=None):
    """Pendulum derivatives along numpy-seeded rollouts with non-trivial
    multipliers (≙ tests/test_pallas_riccati.py::make_batch), as the JAX
    Derivs plus (val, jac)."""
    rng = np.random.default_rng(7)
    problem = jax_pendulum_problem(H, jnp.dtype(np_dtype), target=2.0)
    x0s = jnp.asarray(0.4 * rng.normal(size=(B, 2)), np_dtype)
    us = jnp.asarray(0.3 * rng.normal(size=(B, H, 1)), np_dtype)
    xs = jax.jit(jax.vmap(problem.rollout))(x0s, us)
    derivs = jax.jit(jax.vmap(problem.derivatives))(xs, us)
    mults = jax.vmap(lambda x: jal.init_multipliers(problem, x))(xs)
    val = jnp.asarray(0.3 * rng.normal(size=mults.val.shape), np_dtype)
    jac = jnp.asarray(0.1 * rng.normal(size=mults.jac.shape), np_dtype)
    if bad_lane is not None:
        # lane's Quu indefinite at every step, so its Cholesky fails
        derivs = derivs._replace(
            luu=derivs.luu.at[bad_lane].set(-10.0 * jnp.eye(1, dtype=np_dtype))
        )
    return derivs, val, jac


def pallas_sweep(packed, mu, reg, H):
    """The Pallas kernel in interpret mode, jitted (one trace per shape)."""
    fn = jax.jit(
        lambda p, m_, r_: backward_sweep_pallas(
            p, m_, r_, T=H, n=2, m=1, e=1, block_b=mu.shape[0], interpret=True
        )
    )
    return fn(packed, jnp.asarray(mu), jnp.asarray(reg))


def packed_torch(derivs, val, jac):
    return {k: t(v) for k, v in jax_pack(derivs, val, jac).items()}


@pytest.mark.parametrize(
    "np_dtype,rtol,atol",
    [(np.float64, 1e-10, 1e-10), (np.float32, 2e-4, 2e-5)],
    ids=["f64", "f32"],
)
def test_reference_matches_pallas_interpret(np_dtype, rtol, atol):
    B, H = 8, 16
    derivs, val, jac = pendulum_batch(B, H, np_dtype)
    mu = np.full((B,), 1e3, np_dtype)
    reg = np.zeros((B,), np_dtype)
    packed = jax_pack(derivs, val, jac)
    k_j, K_j, ok_j = pallas_sweep(packed, mu, reg, H)
    k_t, K_t, ok_t = rs.backward_sweep_reference(
        {k: t(v) for k, v in packed.items()}, t(mu), t(reg), T=H, n=2, m=1, e=1
    )
    assert k_t.dtype == TORCH_DTYPE[np_dtype]
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=rtol, atol=atol)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.all()


def test_reference_matches_xla_sweep_arm_dims():
    """UR5-class dims (n=12, m=6, e=6), the kernel's other instantiation:
    random SPD blocks through the XLA sweep and the port's plain version."""
    B, T, n, m, e = 4, 10, 12, 6, 6
    fields, pe, pex = random_spd_derivs(B, T, n, m, e, seed=3)
    mu = np.full((B,), 1e3)
    reg = np.full((B,), 1e-6)
    k_j, K_j, ok_j = jax.vmap(jax_backward_sweep)(
        to_jax_derivs(fields), jnp.asarray(pe), jnp.asarray(pex),
        jnp.asarray(mu), jnp.asarray(reg),
    )  # fmt: skip
    packed = rs.pack_batch_last(to_torch_derivs(fields), t(pe), t(pex))
    k_t, K_t, ok_t = rs.backward_sweep_reference(packed, t(mu), t(reg), T=T, n=n, m=m, e=e)
    assert bool(np.all(ok_j)) and bool(ok_t.all())
    np.testing.assert_allclose(
        k_t.permute(2, 0, 1).numpy(), np.asarray(k_j), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        K_t.reshape(T, m, n, B).permute(3, 0, 1, 2).numpy(),
        np.asarray(K_j), rtol=1e-9, atol=1e-9,
    )  # fmt: skip


def test_ok_is_per_lane():
    """A lane whose factorization fails flips only its own ok flag, and
    the healthy lanes' gains stay finite (≙ test_pallas_ok_is_per_sample)."""
    B, H, bad = 8, 16, 3
    derivs, val, jac = pendulum_batch(B, H, np.float64, bad_lane=bad)
    mu = np.full((B,), 1e3)
    reg = np.zeros((B,))
    packed = jax_pack(derivs, val, jac)
    _, _, ok_j = pallas_sweep(packed, mu, reg, H)
    k_t, _, ok_t = rs.backward_sweep_reference(
        packed_torch(derivs, val, jac), t(mu), t(reg), T=H, n=2, m=1, e=1
    )
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert not bool(ok_t[bad])
    assert bool(ok_t[torch.arange(B) != bad].all())
    assert bool(torch.isfinite(k_t[:, :, torch.arange(B) != bad]).all())
    assert bool(torch.isnan(k_t[:, :, bad]).all())


def test_pack_batch_last_matches_jax_exactly():
    B, H = 8, 16
    derivs, val, jac = pendulum_batch(B, H, np.float64)
    ref = jax_pack(derivs, val, jac)
    got = rs.pack_batch_last(
        TDerivs(*[t(x) for x in derivs]), t(val), t(jac)
    )
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch():
    B, H = 8, 16
    derivs, val, jac = pendulum_batch(B, H, np.float64)
    packed = packed_torch(derivs, val, jac)
    mu, reg = torch.full((B,), 1e3, dtype=torch.float64), torch.zeros(B, dtype=torch.float64)
    before = rs.LAUNCHES
    got = rs.backward_sweep(packed, mu, reg, T=H, n=2, m=1, e=1)
    ref = rs.backward_sweep_reference(packed, mu, reg, T=H, n=2, m=1, e=1)
    assert rs.LAUNCHES == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_second_order_terms_are_not_ported():
    B, H = 2, 4
    fields, pe, pex = random_spd_derivs(B, H, 2, 1, 1, seed=0)
    tderivs = to_torch_derivs(fields)
    with pytest.raises(NotImplementedError, match="slice C"):
        rs.pack_batch_last(tderivs, t(pe), t(pex), second_order=True)
    packed = rs.pack_batch_last(tderivs, t(pe), t(pex))
    packed["fxx"] = torch.zeros(H, 8, B, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="slice C"):
        rs.backward_sweep(packed, t(np.ones(B)), t(np.zeros(B)), T=H, n=2, m=1, e=1)
