"""ddp_tpu_torch.kernels.riccati_small against ddp_tpu's Riccati backward.

The CUDA kernel itself runs only on a card (``chip_smoke.py`` holds it to
the plain version there); on the CPU the wrapper takes the plain PyTorch
version, which these tests hold to the Pallas kernel in interpret mode, to
the XLA sweep and to both of ddp_tpu's regularization ladders, on the same
numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.kernels.riccati_small import backward_sweep_pallas
from ddp_tpu.kernels.riccati_small import pack_batch_last as jax_pack
from ddp_tpu.solver import al as jal
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.batched import _backward_pallas_levels
from ddp_tpu.solver.batched import _backward_sweep as jax_backward_sweep
from ddp_tpu_torch.kernels import _build
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.ocp.problem import Derivs as TDerivs
from ddp_tpu_torch.solver import batched as tbatched

from torch_parity_helpers import (
    TORCH_DTYPE,
    jax_pendulum_problem,
    random_spd_derivs,
    t,
    to_jax_derivs,
    to_torch_derivs,
)


def pendulum_batch(B, H, np_dtype, bad_lane=None, second_order=False):
    """Pendulum derivatives along numpy-seeded rollouts with non-trivial
    multipliers (≙ tests/test_pallas_riccati.py::make_batch), as the JAX
    Derivs plus (val, jac)."""
    rng = np.random.default_rng(7)
    problem = jax_pendulum_problem(
        H, jnp.dtype(np_dtype), target=2.0, second_order=second_order
    )
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


def pallas_sweep(packed, mu, reg, H, n=2, m=1, e=1):
    """The Pallas kernel in interpret mode, jitted (one trace per shape)."""
    fn = jax.jit(
        lambda p, m_, r_: backward_sweep_pallas(
            p, m_, r_, T=H, n=n, m=m, e=e, block_b=mu.shape[0], interpret=True
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
    args = (TDerivs(*[t(x) for x in derivs]), t(val), t(jac), torch.full((B,), 1e3, dtype=torch.float64))
    levels = torch.stack([torch.zeros(B, dtype=torch.float64), torch.full((B,), 2e3, dtype=torch.float64)])
    before = rs.LAUNCHES, rs.LEVELS_SWEPT
    got = rs.backward_ladder(*args, levels)
    ref = rs.backward_ladder_reference(*args, levels)
    assert (rs.LAUNCHES, rs.LEVELS_SWEPT) == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_second_order_terms_are_not_ported():
    """Second order at (12, 6, 12), once not ported, and every other shape
    that passes the gates map to a library of their own, built at the
    first call (nothing is built here).  The packing carries the six rank-3
    slabs, and on CPU tensors the wrapper runs them through the plain
    version."""
    B, H = 2, 4
    fields, pe, pex = random_spd_derivs(B, H, 2, 1, 1, seed=0)
    packed = rs.pack_batch_last(to_torch_derivs(fields), t(pe), t(pex), second_order=True)
    assert set(packed) - set(rs.pack_batch_last(to_torch_derivs(fields), t(pe), t(pex))) == set(
        rs._INPUTS_SECOND_ORDER
    )
    assert packed["fxx"].shape == (H, 8, B) and packed["equu"].shape == (H, 1, B)
    k, K, ok, reg_used = rs.backward_ladder(
        to_torch_derivs(fields), t(pe), t(pex), t(np.ones(B)), t(np.zeros((1, B))), True
    )
    assert bool(ok.all()) and k.shape == (B, H, 1) and K.shape == (B, H, 1, 2)
    assert bool((reg_used == 0).all())
    f12, pe12, pex12 = second_order_fields(B, H, 12, 6, 12, seed=0)
    plan = rs.plan_launch(
        to_torch_derivs(f12), t(pe12), t(pex12), t(np.ones(B)), t(np.zeros((1, B))), True
    )
    assert plan.ints == (1, 1, 12, 6, 12, H, B, 1)
    assert len(plan.inputs) == 22 and plan.inputs[rs._INPUTS.index("pex")].shape == (B, H, 144)
    assert rs.instantiation(12, 6, 12, True) == {"N": 12, "M": 6, "E": 12, "SO": 1}
    shapes = [(12, 6, 12, True), (12, 6, 12, False), (12, 6, 6, True), (4, 2, 2, False),
              (6, 3, 3, True)]  # fmt: skip
    paths = {_build.library_path(rs.SOURCE, rs.instantiation(*s)) for s in shapes}
    assert len(paths) == len(shapes) and not _build.loaded()


def test_launch_gates_raise_before_any_build():
    """Level counts, dtypes and shapes the kernel does not take raise before
    anything is built (this runs where there is no compiler)."""
    B, H = 3, 4
    fields, pe, pex = random_spd_derivs(B, H, 14, 7, 3, seed=1)
    d, mu = to_torch_derivs(fields), t(np.ones(B))
    with pytest.raises(ValueError, match="1 <= L <= 16"):
        rs.plan_launch(d, t(pe), t(pex), mu, t(np.zeros((17, B))), False)
    with pytest.raises(TypeError, match="float32 or float64"):
        rs.plan_launch(d, t(pe), t(pex), mu.half(), t(np.zeros((1, B))), False)
    with pytest.raises(ValueError, match="pex: shape"):
        rs.plan_launch(d, t(pe), t(pex[:, :, :2]), mu, t(np.zeros((1, B))), False)
    with pytest.raises(ValueError, match="levels: torch.float32"):
        rs.plan_launch(d, t(pe), t(pex), mu, t(np.zeros((2, B), np.float32)), False)
    # any (n, m, e) has a library of its own; the large-dims program's
    # widths and e >= 1 are the kernel's bounds
    f3, pe3, pex3 = random_spd_derivs(B, H, 3, 1, 1, seed=1)
    plan = rs.plan_launch(to_torch_derivs(f3), t(pe3), t(pex3), mu, t(np.zeros((1, B))), False)
    assert plan.ints[2:5] == (3, 1, 1)
    with pytest.raises(ValueError, match=r"n <= 31 and m <= 32"):
        rs.instantiation(32, 4, 4)
    with pytest.raises(ValueError, match=r"n, m, e >= 1"):
        rs.instantiation(2, 1, 0)


@pytest.mark.parametrize(
    "second_order,dims",
    [(False, (14, 7, 3)), (True, (14, 7, 3)), (False, (2, 1, 1)), (True, (4, 2, 2))],
    ids=["gn", "so", "gn_n2", "so_n4"],
)
def test_lane_major_inputs_are_the_batch_last_rows(second_order, dims):
    """Both kernel programs read each lane's step slab straight from the
    batch-major Derivs: row r of a [B, T, rows] input at (b, t) must be row r
    of ``pack_batch_last``'s [T, rows, B] at (t, b), rank-3 slabs included
    (row (o·r + i)·c + j)."""
    B, T = 3, 4
    n, m, e = dims
    fields, pe, pex = second_order_fields(B, T, n, m, e, seed=6)
    d, mu = to_torch_derivs(fields), t(np.ones(B))
    lane = rs.kernel_inputs(d, t(pe), t(pex), mu, t(np.zeros((1, B))), second_order)
    assert torch.equal(lane.pop("mu"), mu) and lane.pop("levels").shape == (1, B)
    packed = rs.pack_batch_last(d, t(pe), t(pex), second_order=second_order)
    assert set(packed) == set(lane)
    for key, x in lane.items():
        assert x.is_contiguous(), key
        if key in ("lfx", "lfxx"):
            assert torch.equal(x, packed[key].T), key
        else:
            assert x.shape == (B, T, packed[key].shape[1]), key
            assert torch.equal(x.permute(1, 2, 0), packed[key]), key


# ------------------------------------------------------------- second order


def second_order_fields(B, T, n, m, e, seed, scale=2e-4):
    """``random_spd_derivs`` with non-zero, symmetric dynamics and constraint
    Hessians (small against the SPD cost Hessian, so Quu stays PD)."""
    fields, pe, pex = random_spd_derivs(B, T, n, m, e, seed)
    rng = np.random.default_rng(seed + 100)
    nz = n + m
    for name, rows in (("f", n), ("eq", e)):
        G = scale * rng.normal(size=(B, T, rows, nz, nz))
        G = 0.5 * (G + np.swapaxes(G, -1, -2))
        fields[f"{name}xx"] = np.ascontiguousarray(G[..., :n, :n])
        fields[f"{name}ux"] = np.ascontiguousarray(G[..., n:, :n])
        fields[f"{name}uu"] = np.ascontiguousarray(G[..., n:, n:])
    return fields, pe, pex


@pytest.mark.parametrize(
    "np_dtype,rtol,atol",
    [(np.float64, 1e-10, 1e-10), (np.float32, 2e-4, 2e-5)],
    ids=["f64", "f32"],
)
def test_second_order_reference_matches_pallas_and_sweeps(np_dtype, rtol, atol):
    """Full-DDP mode on the pendulum
    (≙ test_pallas_riccati.py::test_pallas_backward_second_order_matches_xla):
    the plain version's rank-3 terms against the Pallas kernel in interpret
    mode, against ddp_tpu's XLA sweep and against the port's own sweep."""
    B, H = 8, 12
    derivs, val, jac = pendulum_batch(B, H, np_dtype, second_order=True)
    # tensor terms must be nonzero for this test to mean anything
    assert float(jnp.max(jnp.abs(derivs.fxx))) > 0 and float(jnp.max(jnp.abs(derivs.eqxx))) > 0
    mu = np.full((B,), 1e3, np_dtype)
    reg = np.zeros((B,), np_dtype)
    packed = jax_pack(derivs, val, jac, second_order=True)
    k_p, K_p, ok_p = pallas_sweep(packed, mu, reg, H)
    k_x, K_x, ok_x = jax.vmap(jax_backward_sweep)(derivs, val, jac, jnp.asarray(mu), jnp.asarray(reg))
    tderivs = TDerivs(*[t(x) for x in derivs])
    tpacked = rs.pack_batch_last(tderivs, t(val), t(jac), second_order=True)
    for key in packed:
        np.testing.assert_array_equal(tpacked[key].numpy(), np.asarray(packed[key]), err_msg=key)
    k_t, K_t, ok_t = rs.backward_sweep_reference(tpacked, t(mu), t(reg), T=H, n=2, m=1, e=1)
    assert k_t.dtype == TORCH_DTYPE[np_dtype] and bool(ok_t.all())
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_p), rtol=rtol, atol=atol)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_p), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_p))
    k_bt, K_bt = k_t.permute(2, 0, 1), K_t.reshape(H, 1, 2, B).permute(3, 0, 1, 2)
    np.testing.assert_allclose(k_bt.numpy(), np.asarray(k_x), rtol=rtol, atol=atol)
    np.testing.assert_allclose(K_bt.numpy(), np.asarray(K_x), rtol=rtol, atol=atol)
    k_s, K_s, ok_s = tbatched._backward_sweep(tderivs, t(val), t(jac), t(mu), t(reg))
    np.testing.assert_allclose(k_bt.numpy(), k_s.numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(K_bt.numpy(), K_s.numpy(), rtol=rtol, atol=atol)
    assert bool(ok_s.all())
    # … and the terms matter: the Gauss-Newton sweep of the same blocks differs
    k_gn, _, _ = rs.backward_sweep_reference(
        rs.pack_batch_last(tderivs, t(val), t(jac)), t(mu), t(reg), T=H, n=2, m=1, e=1
    )
    assert float((k_gn - k_t).abs().max()) > 1e-6


@pytest.mark.parametrize("dims", [(4, 2, 2), (14, 7, 3)], ids=["n4m2e2", "n14m7e3"])
def test_second_order_reference_matches_xla_sweep_random_blocks(dims):
    """The kernel's other second-order instantiations, with dense random
    Hessian slabs (every index order of fxx/fux/fuu/eqxx/equx/equu matters):
    the plain version against ddp_tpu's XLA sweep, 1e-9."""
    n, m, e = dims
    B, T = 3, 5
    fields, pe, pex = second_order_fields(B, T, n, m, e, seed=4)
    mu, reg = np.full((B,), 1e3), np.full((B,), 1e-6)
    k_j, K_j, ok_j = jax.vmap(jax_backward_sweep)(
        to_jax_derivs(fields), jnp.asarray(pe), jnp.asarray(pex),
        jnp.asarray(mu), jnp.asarray(reg),
    )  # fmt: skip
    packed = rs.pack_batch_last(to_torch_derivs(fields), t(pe), t(pex), second_order=True)
    k_t, K_t, ok_t = rs.backward_sweep_reference(packed, t(mu), t(reg), T=T, n=n, m=m, e=e)
    assert bool(np.all(ok_j)) and bool(ok_t.all())
    np.testing.assert_allclose(
        k_t.permute(2, 0, 1).numpy(), np.asarray(k_j), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        K_t.reshape(T, m, n, B).permute(3, 0, 1, 2).numpy(),
        np.asarray(K_j), rtol=1e-9, atol=1e-9,
    )  # fmt: skip


def test_second_order_ladder_picks_the_sweep_backends_level():
    """With true Hessians Quu is indefinite away from an optimum: a lane
    whose fuu term makes it so fails at reg = 0 with NaN gains, only its own
    ok flag flips, and both ladder backends pick the same level, gains and
    reg for it as ddp_tpu's sweep ladder."""
    Bl, T, n, m, e = 4, 6, 4, 2, 2
    fields, pe, pex = second_order_fields(Bl, T, n, m, e, seed=5)
    fields["fuu"][1] = -40.0 * np.eye(m)  # Vx·fuu swamps luu on lane 1
    mu, reg = np.full((Bl,), 1e3), np.zeros(Bl)
    packed = rs.pack_batch_last(to_torch_derivs(fields), t(pe), t(pex), second_order=True)
    k0, _, ok0 = rs.backward_sweep_reference(packed, t(mu), t(reg), T=T, n=n, m=m, e=e)
    assert ok0.tolist() == [True, False, True, True]
    assert bool(torch.isnan(k0[..., 1]).any()) and bool(torch.isfinite(k0[..., [0, 2, 3]]).all())
    k_j, K_j, ok_j, reg_j = jax.vmap(
        lambda d, v, j, m_, r: jbatched._backward_multi_reg(d, v, j, m_, r, n_levels=4)
    )(to_jax_derivs(fields), pe, pex, mu, reg)
    assert bool(np.all(ok_j)) and np.asarray(reg_j)[1] > 0 and np.asarray(reg_j)[0] == 0
    args = (to_torch_derivs(fields), t(pe), t(pex), t(mu), t(reg), 4)
    for backend, kw in (
        (tbatched._backward_multi_reg, {}),
        (tbatched._backward_kernel_levels, dict(second_order=True)),
    ):
        k, K, ok, reg_u = backend(*args, **kw)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(reg_u.numpy(), np.asarray(reg_j))
        np.testing.assert_allclose(k.numpy(), np.asarray(k_j), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(K.numpy(), np.asarray(K_j), rtol=1e-9, atol=1e-9)


# ------------------------------------------------------------- the ladder


def ladder_fields(second_order, seed=8):
    """Random blocks at (4, 2, 2) (second order) or (2, 1, 1) (Gauss-Newton)
    with lane 1 failing at reg = 0 and at the ladder's first escalation and
    holding at its second (luu = −5e3·I against the levels 0, 2e3, 3.2e4,
    5.12e5 at μ = 1e3), and lane 2 failing at every level."""
    Bl, T = 4, 6
    n, m, e = (4, 2, 2) if second_order else (2, 1, 1)
    if second_order:
        fields, pe, pex = second_order_fields(Bl, T, n, m, e, seed=seed)
    else:
        fields, pe, pex = random_spd_derivs(Bl, T, n, m, e, seed=seed)
    fields["luu"][1] = -5e3 * np.eye(m)
    fields["luu"][2] = -1e9 * np.eye(m)
    return fields, pe, pex, np.full((Bl,), 1e3), np.zeros(Bl), (T, n, m, e)


@pytest.mark.parametrize("reference", ["multi_reg", "pallas_levels"])
@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "so"])
def test_ladder_matches_jax_ladders(second_order, reference):
    """The plain ladder in one call against ddp_tpu's two ladders — the XLA
    sweep's ``_backward_multi_reg`` and the Pallas kernel's
    ``_backward_pallas_levels`` in interpret mode, one launch per level —
    on the same inputs: ok and reg_used equal, gains within 1e-9 (NaN where
    no level held)."""
    fields, pe, pex, mu, reg, (T, n, m, e) = ladder_fields(second_order)
    jd = to_jax_derivs(fields)
    if reference == "multi_reg":
        k_j, K_j, ok_j, reg_j = jax.vmap(
            lambda d, v, j, m_, r: jbatched._backward_multi_reg(d, v, j, m_, r, n_levels=4)
        )(jd, pe, pex, mu, reg)
    else:
        k_j, K_j, ok_j, reg_j = jax.jit(
            lambda d, v, j, m_, r: _backward_pallas_levels(
                d, v, j, m_, r, n_levels=4, interpret=True, second_order=second_order
            )
        )(jd, jnp.asarray(pe), jnp.asarray(pex), jnp.asarray(mu), jnp.asarray(reg))
    assert np.asarray(ok_j).tolist() == [True, True, False, True]
    assert float(np.asarray(reg_j)[1]) == 3.2e4
    levels = torch.stack(tbatched._reg_levels(t(mu), t(reg), 4))
    k, K, ok, reg_u = rs.backward_ladder(
        to_torch_derivs(fields), t(pe), t(pex), t(mu), levels, second_order
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(reg_u.numpy(), np.asarray(reg_j))
    np.testing.assert_allclose(k.numpy(), np.asarray(k_j), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_j), rtol=1e-9, atol=1e-9)
    assert bool(torch.isnan(k[2]).all())  # level 0's failed gains


@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "so"])
def test_ladder_level_is_the_single_level_sweep_bit_for_bit(second_order):
    """A lane saved by level 2 gets exactly the gains a sweep at that level
    alone gives: the ladder sweeps its levels independently and copies."""
    fields, pe, pex, mu, reg, (T, n, m, e) = ladder_fields(second_order)
    d = to_torch_derivs(fields)
    levels = torch.stack(tbatched._reg_levels(t(mu), t(reg), 4))
    k, K, ok, reg_u = rs.backward_ladder(d, t(pe), t(pex), t(mu), levels, second_order)
    k2, K2, ok2, reg2 = rs.backward_ladder(d, t(pe), t(pex), t(mu), levels[2:3], second_order)
    assert bool(ok[1]) and bool(ok2[1]) and float(reg_u[1]) == float(reg2[1]) == 3.2e4
    assert torch.equal(k[1], k2[1]) and torch.equal(K[1], K2[1])
