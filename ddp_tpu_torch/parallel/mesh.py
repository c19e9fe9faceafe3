"""Device-mesh scaling: shard the solve batch over ranks
(≙ ddp_tpu/parallel/mesh.py, ``torch.distributed`` in place of
``jax.sharding``).

Thousands of independent solves (scenarios, initial states) split along the
batch axis over a 1-D ``DeviceMesh`` named ``"batch"``: each rank solves its
contiguous block of B/n rows on its own card, and the global convergence
aggregates ride ``all_reduce(SUM)`` over the mesh's group, as the ``psum``s
inside ddp_tpu's ``shard_map`` do.  Results come back as DTensors sharded
``Shard(0)`` on the mesh (the counterpart of ``P("batch")``); gathering them
(``.full_tensor()``) is the caller's choice.

No collective other than ``all_reduce`` is used: PyTorch's gloo backend
gives CUDA tensors only ``broadcast`` and ``all_reduce``, and gloo is what
runs several ranks on one card (NCCL refuses two ranks on one GPU) and the
CPU tests.  ``make_batch_mesh`` needs the process group to exist:
``multihost_init`` starts it from ``torchrun``'s environment or an address.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from ddp_tpu_torch.solver import al as al_mod
from ddp_tpu_torch.solver.solve import SolverParams, solve_vmap

AXIS = "batch"


def multihost_init(coordinator_address: str | None = None, **kw) -> None:
    """Start the default process group (≙ ``jax.distributed.initialize``):
    from ``torchrun``'s environment (``WORLD_SIZE`` > 1), or from
    ``coordinator_address`` (an ``init_method`` such as
    ``"tcp://host:port"``; ``rank`` and ``world_size`` in ``**kw``).  With
    neither, a world of one process, it does nothing.  ``**kw`` goes to
    ``torch.distributed.init_process_group`` (``backend`` defaults to
    NCCL when a card is visible, gloo otherwise)."""
    torchrun = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if dist.is_initialized() or (coordinator_address is None and not torchrun):
        return
    kw.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is not None:
        kw["init_method"] = coordinator_address
    dist.init_process_group(**kw)


def make_batch_mesh(n_devices: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named ``"batch"`` over every rank of the default process
    group, on the card by default (``device_type="cpu"`` for gloo ranks on
    the host).  Rank r works on ``cuda:(local_rank % device_count)``,
    ``local_rank`` from ``LOCAL_RANK`` (``torchrun``) or the global rank.

    ``n_devices`` must be the world size: ddp_tpu takes the first n of a
    host's devices, but a rank here is a process that either belongs to the
    mesh or holds no part of the batch."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_batch_mesh needs the default process group: call multihost_init() "
            "(torchrun) or torch.distributed.init_process_group first"
        )
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a batch mesh spans every rank: n_devices={n_devices}, world size {world}")
    if device_type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    return init_device_mesh(device_type, (world,), mesh_dim_names=(AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's block lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_block(x, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a batch-leading tensor: the global tensor (the same
    on every rank) cut into ``mesh.size()`` contiguous blocks, or the local
    part of a DTensor sharded ``Shard(0)`` on ``mesh``."""
    if isinstance(x, DTensor):
        if x.device_mesh != mesh or tuple(x.placements) != (Shard(0),):
            raise ValueError(f"expected a DTensor sharded Shard(0) on {mesh}, got {x.placements}")
        return x.to_local()
    n, B = mesh.size(), x.shape[0]
    if B % n:
        raise ValueError(f"the batch of {B} does not divide over the {n} ranks of the mesh")
    b = B // n
    r = mesh.get_local_rank(AXIS)
    return x[r * b:(r + 1) * b]  # fmt: skip


def sharded(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> DTensor:
    """This rank's block ``x`` as its part of a DTensor sharded on ``dim``."""
    return DTensor.from_local(x, mesh, [Shard(dim)], run_check=False)


def global_sum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Σ over every rank's ``x`` (≙ ``lax.psum`` over "batch")."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(AXIS))
    return x


def global_mean(per_lane: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The mean over the global batch of a per-lane [b] tensor: the psum of
    each rank's sum over the global count."""
    return global_sum(per_lane.sum(), mesh) / (per_lane.shape[0] * mesh.size())


def batch_sharded_solve(problem, params: SolverParams, mesh: DeviceMesh):
    """fn(x0s [B, nx]) → (us [B, T, nu], {"mean_constr", "n_converged"}):
    each rank solves its B/n rows through ``solve_vmap``.  ``x0s`` is the
    global batch, the same on every rank, or a DTensor sharded ``Shard(0)``
    on ``mesh``; ``us`` is a DTensor sharded ``Shard(0)``, the aggregates
    plain tensors reduced over the mesh.  A batch that the ranks do not
    divide raises ``ValueError``."""

    def fn(x0s):
        res = solve_vmap(problem, params, local_block(x0s, mesh))
        mean_constr = global_mean(res.stats.opt_constr, mesh)
        n_converged = global_sum(res.stats.converged.sum(), mesh)
        return sharded(res.us, mesh), {"mean_constr": mean_constr, "n_converged": n_converged}

    return fn


def batch_sharded_solve_batched(problem, params: SolverParams, mesh: DeviceMesh, **kw):
    """fn(x0s [B, nx]) → (BatchSolveResult, {"mean_constr"}) of the
    fixed-budget production path, ``solve_batched`` on each rank's block.
    ``**kw`` forwards to it, so ``backward="kernel"`` launches the Riccati
    kernel once a backward call on each rank's local block.  Every field of
    the result is a DTensor sharded ``Shard(0)`` on ``mesh`` (the history's
    [I, B] fields ``Shard(1)``).  Inputs as ``batch_sharded_solve``'s."""
    from ddp_tpu_torch.solver.batched import BatchSolveHistory, BatchSolveResult, solve_batched

    def fn(x0s):
        res = solve_batched(problem, params, local_block(x0s, mesh), **kw)
        mean_constr = global_mean(res.opt_constr, mesh)
        hist = res.history
        if hist is not None:
            hist = BatchSolveHistory(*(sharded(h, mesh, 1) for h in hist))
        out = BatchSolveResult(*(
            al_mod.AffineMults(*(sharded(m, mesh) for m in f)) if isinstance(f, al_mod.AffineMults)
            else sharded(f, mesh)
            for f in res[:-1]
        ), history=hist)  # fmt: skip
        return out, {"mean_constr": mean_constr}

    return fn
