"""Checkpoint and resume of solver and MPC state (≙ ddp_tpu/utils/checkpoint.py).

Persists (trajectory, multipliers, μ/reg schedule, warm starts) so that a
restarted controller host resumes mid-run.  The format is ``ddp_tpu``'s
``.npz`` fallback: one array ``leaf_{i}`` per leaf in flatten order, where
flattening follows JAX's rules for the containers state is made of —
tuples, lists and NamedTuples in order, dicts by sorted key, ``None`` no
leaf at all — so a checkpoint either package writes loads into the other's
structure.  A path without the ``.npz`` suffix gets it.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _rebuild(like, leaves):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(sub, leaves) for sub in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(sub, leaves) for sub in like)
    return next(leaves)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree) -> None:
    """Save a pytree of tensors (BatchSolveResult, AffineMults, MPCCarry, …)."""
    flat = {
        f"leaf_{i}": leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        for i, leaf in enumerate(_leaves(tree))
    }  # fmt: skip
    np.savez(_npz(path), **flat)


def load(path: str, like):
    """Load into the structure of ``like`` (a template pytree); each tensor
    lands on the device of the template's leaf, in the dtype it was saved
    in."""
    with np.load(_npz(path)) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(_leaves(like)))]
    tensors = (
        torch.from_numpy(a).to(leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        for a, leaf in zip(arrays, _leaves(like))
    )
    return _rebuild(like, tensors)
