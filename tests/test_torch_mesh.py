"""ddp_tpu_torch's device mesh (``parallel/mesh.py``) and fleet MPC
(``solver/mpc.py::make_batch_mpc_step``) against ddp_tpu, f64 on the CPU:
the three mesh anchors of tests/test_aux_subsystems.py
(``test_mesh_sharded_batch_solve``, ``test_mesh_sharded_solve_batched_pallas``,
``test_batch_mpc_step_on_mesh``) at their configurations and bars, the port's
functions run by two gloo ranks (spawned, a ``file://`` store under
``tmp_path``), each result held to the unsharded port and to ddp_tpu's run;
the cheap checks in one process at world size 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_aux_subsystems import make_problem
from torch.distributed.tensor import DTensor, Shard
from torch_mesh_ranks import spawn_ranks, world_of_one
from torch_parity_helpers import spec_of, t, torch_problem

from ddp_tpu.solver import mpc as jmpc
from ddp_tpu.solver.batched import solve_batched as jsolve_batched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu.solver.solve import solve as jsolve
from ddp_tpu_torch.parallel import mesh as pm
from ddp_tpu_torch.solver import mpc
from ddp_tpu_torch.solver.batched import solve_batched
from ddp_tpu_torch.solver.solve import SolverParams, solve_vmap

jax.config.update("jax_enable_x64", True)

SOLVE = dict(max_iterations=15, threshold=1e-8, mu=1e6)  # test_mesh_sharded_batch_solve
BATCHED = dict(max_iterations=4, threshold=1e-8, mu=1e5, inner_iters_max=1)  # …_pallas
MPC = dict(max_iterations=3, threshold=1e-6, mu=1e5)  # test_batch_mpc_step_on_mesh
B = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: six pytest workers
    share the host's cores, and these solves run no slower alone on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def solve_x0s():
    return np.stack([[0.05 * i, 0.0] for i in range(B)])


def batched_x0s():
    return np.stack([[0.05 * i, 0.01] for i in range(B)])


def mpc_x0s():
    return np.stack([[0.03 * i, 0.0] for i in range(B)])


@pytest.fixture(scope="module")
def problems():
    return {h: make_problem(dtype=jnp.float64, horizon=h) for h in (20, 12)}


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    """The three functions run by two gloo ranks (tests/torch_mesh_ranks.py)."""
    return spawn_ranks(tmp_path_factory.mktemp("mesh"), 2, "mesh_tasks",
                       solve_spec=spec_of(problems[20]), batched_spec=spec_of(problems[12]),
                       mpc_spec=spec_of(problems[20]))  # fmt: skip


def joined(ranks, part, name):
    """The global batch of a rank-local result: the ranks' blocks in order."""
    assert [r["rank"] for r in ranks] == [0, 1] and all(r["size"] == 2 for r in ranks)
    return torch.cat([r[part][name] for r in ranks], dim=-2 if name == "u0" else 0).numpy()


def test_mesh_sharded_batch_solve(problems, ranks):
    """≙ test_mesh_sharded_batch_solve: the batch split over two ranks
    equals the unsharded ``solve_vmap`` and ddp_tpu's ``jax.vmap(solve)``
    (rtol 1e-5, atol 1e-6); ``mean_constr`` (rtol 1e-12) and
    ``n_converged`` (equal) are the global reductions of the unsharded
    solve on every rank, and ddp_tpu's at the bar of ``us``."""
    jp = problems[20]
    ref = jax.jit(jax.vmap(lambda x: jsolve(jp, JParams(**SOLVE), x)))(jnp.asarray(solve_x0s()))
    port = solve_vmap(torch_problem(jp), SolverParams(**SOLVE), t(solve_x0s()))
    us = joined(ranks, "solve", "us")
    assert ranks[0]["solve"]["shape"] == (B, 20, 1)
    assert ranks[0]["solve"]["placements"] == "(Shard(dim=0),)"
    for other in (np.asarray(ref.us), port.us.numpy()):
        np.testing.assert_allclose(us, other, rtol=1e-5, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(float(r["solve"]["mean_constr"]), float(jnp.mean(ref.stats.opt_constr)),
                                   rtol=1e-5, atol=1e-6)  # fmt: skip
        np.testing.assert_allclose(float(r["solve"]["mean_constr"]), float(port.stats.opt_constr.mean()),
                                   rtol=1e-12)  # fmt: skip
        assert int(r["solve"]["n_converged"]) == int(jnp.sum(ref.stats.converged))
        assert int(r["solve"]["n_converged"]) == int(port.stats.converged.sum())


def test_mesh_sharded_solve_batched_kernel(problems, ranks):
    """≙ test_mesh_sharded_solve_batched_pallas: ``solve_batched`` with
    ``backward="kernel"`` on each rank's block equals the unsharded run and
    ddp_tpu's ``backward="pallas"`` in interpret mode (rtol 1e-9, atol
    1e-12), ``mean_constr`` the global mean (rtol 1e-12)."""
    jp = problems[12]
    ref = jax.jit(lambda x: jsolve_batched(jp, JParams(**BATCHED), x, backward="pallas", interpret=True,
                                           block_b=2))(jnp.asarray(batched_x0s()))  # fmt: skip
    port = solve_batched(torch_problem(jp), SolverParams(**BATCHED), t(batched_x0s()), backward="kernel")
    assert ranks[0]["batched"]["shape"] == (B, 12, 1)
    for name, jref, pref in (("us", ref.us, port.us), ("opt_constr", ref.opt_constr, port.opt_constr)):
        got = joined(ranks, "batched", name)
        for other in (np.asarray(jref), pref.numpy()):
            np.testing.assert_allclose(got, other, rtol=1e-9, atol=1e-12)
    assert np.array_equal(joined(ranks, "batched", "mu"), port.mu.numpy())
    for r in ranks:
        np.testing.assert_allclose(float(r["batched"]["mean_constr"]), float(jnp.mean(ref.opt_constr)),
                                   rtol=1e-12)  # fmt: skip


def test_batch_mpc_step_on_mesh(problems, ranks):
    """≙ test_batch_mpc_step_on_mesh: three fleet replans split over two
    ranks, the plant stepped on each rank's block, against ddp_tpu's
    unsharded replans with the same warm-start rule (rtol 1e-6, atol 1e-8)
    and against the port's fleet step at world size 1 in this process
    (rtol 1e-9, atol 1e-12); ``mean_constr`` the global mean of each
    replan."""
    jp = problems[20]
    jparams = JParams(**MPC)
    ref_solve = jax.jit(lambda xr, cr: jsolve_batched(
        jp, jparams, xr, us_init=cr.us_warm, mults_init=cr.mults,
        mu_init=jnp.maximum(cr.mu, jparams.mu), reg_init=jnp.maximum(cr.reg, jparams.reg),
    ))  # fmt: skip
    x = jnp.asarray(mpc_x0s())
    carry = jmpc.init_batch_carry(jp, B, jnp.float64, x0s=x)
    u0s, means = [], []
    for _ in range(3):
        res = ref_solve(x, carry)
        carry = jmpc.MPCCarry(
            us_warm=jnp.concatenate([res.us[:, 1:], res.us[:, -1:]], axis=1), mults=res.mults,
            mu=jnp.clip(res.mu / 10.0, jparams.mu, 100.0 * jparams.mu), reg=res.reg,
        )  # fmt: skip
        u0s.append(np.asarray(res.us[:, 0]))
        means.append(float(jnp.mean(res.opt_constr)))
        x = jax.vmap(lambda xx, uu: jp.dynamics(0, xx, uu))(x, res.us[:, 0])
    got = joined(ranks, "mpc", "u0")
    np.testing.assert_allclose(got, np.stack(u0s), rtol=1e-6, atol=1e-8)
    for r in ranks:
        np.testing.assert_allclose(r["mpc"]["mean_constr"].numpy(), means, rtol=1e-6)
    with world_of_one() as mesh:
        tp = torch_problem(jp)
        step = mpc.make_batch_mpc_step(tp, SolverParams(**MPC), mesh)
        x = t(mpc_x0s())
        carry = mpc.init_batch_carry(tp, B, torch.float64, x0s=x)
        for i in range(3):
            u0, carry, mean_c = step(x, carry)
            np.testing.assert_allclose(got[i], u0.to_local().numpy(), rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(float(ranks[0]["mpc"]["mean_constr"][i]), float(mean_c), rtol=1e-12)
            x = tp.dynamics(0, x, u0.to_local())
    assert np.array_equal(joined(ranks, "mpc", "mu"), carry.mu.to_local().numpy())


def test_dtensor_input_and_indivisible_batch(ranks):
    """A ``Shard(0)`` DTensor input gives the bits of the global batch; a
    batch of 15 that two ranks do not divide raises ``ValueError`` on every
    rank, as ``shard_map`` does."""
    assert np.array_equal(joined(ranks, "solve_dtensor_input", "us"), joined(ranks, "solve", "us"))
    for r in ranks:
        assert r["indivisible"].startswith("ValueError: the batch of 15 does not divide over the 2 ranks")
        assert torch.equal(r["solve_dtensor_input"]["mean_constr"], r["solve"]["mean_constr"])


def test_world_of_one_in_process():
    """At world size 1: the mesh is named "batch" and spans the one rank,
    ``n_devices`` other than the world size raises ``ValueError``, the
    aggregates equal the local ones exactly and the results are ``Shard(0)``
    DTensors over the whole batch.  Without a process group
    ``make_batch_mesh`` raises and ``multihost_init`` with no address and no
    torchrun environment starts none."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_batch_mesh(device_type="cpu")
    pm.multihost_init()
    assert not dist.is_initialized()
    jp = make_problem(dtype=jnp.float64, horizon=8)
    tp = torch_problem(jp)
    x0s = t(np.stack([[0.1 * i, 0.0] for i in range(3)]))
    params = SolverParams(4, 1e-8, mu=1e5, inner_iters_max=1)
    with world_of_one() as mesh:
        assert mesh.mesh_dim_names == ("batch",) and mesh.size() == 1
        assert pm.mesh_device(mesh) == torch.device("cpu")
        with pytest.raises(ValueError, match="n_devices=2"):
            pm.make_batch_mesh(2, device_type="cpu")
        res, stats = pm.batch_sharded_solve_batched(tp, params, mesh, history=True)(x0s)
        ref = solve_batched(tp, params, x0s, history=True)
        assert isinstance(res.mults.jac, DTensor) and res.mults.jac.placements == (Shard(0),)
        assert res.history.mu.placements == (Shard(1),)
        for got, want in zip((res.us, res.mu, res.mults.val, res.history.mu), (ref.us, ref.mu, ref.mults.val,
                                                                              ref.history.mu)):  # fmt: skip
            assert torch.equal(got.to_local(), want)
        assert float(stats["mean_constr"]) == float(ref.opt_constr.mean())
        us, stats = pm.batch_sharded_solve(tp, params, mesh)(x0s)
        ref = solve_vmap(tp, params, x0s)
        assert torch.equal(us.to_local(), ref.us) and tuple(us.shape) == (3, 8, 1)
        assert float(stats["mean_constr"]) == float(ref.stats.opt_constr.mean())
        assert int(stats["n_converged"]) == int(ref.stats.converged.sum())
    assert not dist.is_initialized()
