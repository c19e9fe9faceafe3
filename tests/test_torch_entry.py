"""ddp_tpu_torch's entry points (``ddp_tpu_torch/entry.py``) against
``__graft_entry__.py`` on the CPU: ``entry()``'s problem, inputs and
controls, and ``dryrun_multichip`` at world size 1 in this process (gloo),
whose row has the keys of the row ``__graft_entry__.py`` appends to
``benchmarks/results.jsonl`` (this test runs no ddp_tpu dry run: that one
writes the file)."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as graft
from ddp_tpu.solver.solve import solve as jsolve
from ddp_tpu_torch import entry as tentry
from ddp_tpu_torch.solver.solve import solve_vmap

# the row of __graft_entry__.py:136-148
ROW_KEYS = {
    "metric", "t", "n_devices", "B", "T", "iters", "frac_feasible_1e-2", "wall_s_per_step",
    "wall_s_first_incl_compile", "platform", "note",
}  # fmt: skip


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: six pytest workers
    share the host's cores, and these solves run no slower alone on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lane_scaled_err(a, b):
    """max_t |a − b| of each lane over that lane's largest |b| (at least 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max(axis=(1, 2)) / np.maximum(np.abs(b).max(axis=(1, 2)), 1.0)


def test_entry_matches_graft_entry():
    """``entry(device="cpu")`` against ``__graft_entry__.entry()``: the same
    8 starts in float32 and controls [8, 32, 1].  The problem in float64
    (``_make_problem``) through ``solve_vmap`` and ddp_tpu's
    ``jax.vmap(solve)``: us within 1e-8 of each lane's largest |u|, identical
    iterations and μ.  In float32 this 12-iteration solve is not resolved to
    1e-3 (ddp_tpu's own float32 controls end up to 8.7e-3 of their scale from
    its float64 ones, on another μ path): each lane of ``entry``'s controls
    lies within that distance of ddp_tpu's float32 ones."""
    jfn, (jx0s,) = graft.entry()
    fn, (x0s,) = tentry.entry(device="cpu")
    assert x0s.dtype == torch.float32 and x0s.device.type == "cpu"
    np.testing.assert_array_equal(x0s.numpy(), np.asarray(jx0s))
    ref32 = np.asarray(jax.jit(jfn)(jx0s))
    us32 = fn(x0s).numpy()
    assert us32.shape == ref32.shape == (8, 32, 1) and np.isfinite(us32).all()

    jp, jparams = graft._make_problem(32, jnp.float64)
    ref64 = jax.jit(jax.vmap(lambda x: jsolve(jp, jparams, x)))(jnp.asarray(jx0s, jnp.float64))
    tp, params = tentry._make_problem(32, torch.float64, device="cpu")
    res64 = solve_vmap(tp, params, x0s.double())
    assert lane_scaled_err(res64.us, ref64.us).max() <= 1e-8
    np.testing.assert_array_equal(res64.stats.iterations.numpy(), np.asarray(ref64.stats.iterations))
    np.testing.assert_array_equal(res64.stats.mu.numpy(), np.asarray(ref64.stats.mu))

    f32_floor = lane_scaled_err(ref32, ref64.us).max()
    assert lane_scaled_err(us32, ref32).max() <= f32_floor, (lane_scaled_err(us32, ref32), f32_floor)


def test_dryrun_multichip_world_of_one():
    """``dryrun_multichip(1)`` on a gloo group of one rank in this process:
    the sharded solve, the production path and the contract-shape run
    (B = 4096, feasible share > 0.99), returning ``__graft_entry__``'s row;
    the group is torn down after."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0, world_size=1)
        try:
            row = tentry.dryrun_multichip(1, device_type="cpu")
        finally:
            dist.destroy_process_group()
    assert set(row) == ROW_KEYS
    assert row["metric"] == "multichip_contract_shape" and row["platform"] == "cpu"
    assert (row["n_devices"], row["B"], row["T"], row["iters"]) == (1, 4096, 32, 8)
    assert row["frac_feasible_1e-2"] > 0.99
