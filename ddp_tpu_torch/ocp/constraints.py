"""Equality constraints eq(t, x, u) = 0 with dense masked schedules
(≙ ddp_tpu/ocp/constraints.py).

Protocol: ``ne`` (static width), ``value(t, x, u) -> [..., ne]`` (unmasked,
any leading batch dims) and ``active(t: int) -> bool`` (the static schedule,
read in Python for t in range(horizon)).  The problem layer multiplies values
and Jacobians by the 0/1 activity mask.  A schedule is anything with
``t in schedule``: a tuple of steps, ``every_k`` or ``in_range``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ddp_tpu_torch.models.base import state_split


class NoConstraint(nn.Module):
    """ne = 0: unconstrained problem; all eq arrays are zero-width."""

    ne = 0

    def value(self, t, x, u):
        return x.new_zeros(x.shape[:-1] + (0,))

    def active(self, t: int) -> bool:
        return False


class ConfigTarget(nn.Module):
    """eq = q_target ⊖ q — reach a target configuration at ``active_ts``."""

    def __init__(self, model: nn.Module, target: torch.Tensor, active_ts: tuple = ()):
        super().__init__()
        self.model = model
        self.register_buffer("target", target)
        self.active_ts = active_ts  # any schedule with `t in active_ts`, kept as given

    @property
    def ne(self) -> int:
        return self.model.nv

    def value(self, t, x, u):
        del t, u
        q, _ = state_split(self.model, x)
        return self.model.difference(self.target, q)

    def active(self, t: int) -> bool:
        return t in self.active_ts


class StateTarget(nn.Module):
    """eq = x_target ⊖ x on the whole tangent state (ne = 2·nv): the
    configuration and the velocity, "arrive at rest"."""

    def __init__(self, model: nn.Module, target: torch.Tensor, active_ts: tuple = ()):
        super().__init__()
        self.model = model
        self.register_buffer("target", target)  # [nq + nv]
        self.active_ts = active_ts

    @property
    def ne(self) -> int:
        return 2 * self.model.nv

    def value(self, t, x, u):
        del t, u
        q, v = state_split(self.model, x)
        nq = self.model.nq
        qt, vt = self.target[:nq], self.target[nq:]
        return torch.cat([self.model.difference(qt, q), v - vt], dim=-1)

    def active(self, t: int) -> bool:
        return t in self.active_ts


class FrameTarget(nn.Module):
    """eq = frame_position(frame_id, q) − p_target (3-D end-effector
    target), for a model with frames (``RobotModel``)."""

    ne = 3

    def __init__(
        self, model: nn.Module, target: torch.Tensor, frame_id: int = 0, active_ts: tuple = ()
    ):
        super().__init__()
        self.model = model
        self.register_buffer("target", target)  # [3]
        self.frame_id = int(frame_id)
        self.active_ts = active_ts  # any schedule with `t in active_ts`, kept as given

    def value(self, t, x, u):
        del t, u
        q, _ = state_split(self.model, x)
        return self.model.frame_position(self.frame_id, q) - self.target

    def active(self, t: int) -> bool:
        return t in self.active_ts


class TrajectoryConfigTarget(nn.Module):
    """eq = q_target[t] ⊖ q — track a per-step configuration reference.
    ``targets`` [T_pad, nq] with T_pad ≥ the last active step + 1; the
    gather clamps t into range."""

    def __init__(self, model: nn.Module, targets: torch.Tensor, active_ts: tuple = ()):
        super().__init__()
        self.model = model
        self.register_buffer("targets", targets)
        self.active_ts = active_ts

    @property
    def ne(self) -> int:
        return self.model.nv

    def value(self, t, x, u):
        del u
        q, _ = state_split(self.model, x)
        idx = torch.clamp(torch.as_tensor(t, device=self.targets.device), 0, self.targets.shape[0] - 1)
        return self.model.difference(self.targets[idx], q)

    def active(self, t: int) -> bool:
        return t in self.active_ts


class AdvanceTime(nn.Module):
    """Apply ``inner`` one step ahead through the dynamics:
    eq'(t, x, u) = inner(t+1, f(t, x, u), u).  The same u is forwarded to
    the inner constraint, so a double advance predicts two steps with one u
    (see ddp_tpu.ocp.constraints.AdvanceTime for the modelling consequence)."""

    def __init__(self, inner: nn.Module, dynamics: nn.Module):
        super().__init__()
        self.inner = inner
        self.dynamics = dynamics

    @property
    def ne(self) -> int:
        return self.inner.ne

    def value(self, t, x, u):
        x_next = self.dynamics(t, x, u)
        return self.inner.value(t + 1, x_next, u)

    def active(self, t: int) -> bool:
        return self.inner.active(t + 1)


class StackConstraints(nn.Module):
    """Several constraints concatenated into one eq vector; each part keeps
    its own schedule, so the activity mask is per row (``row_mask``)."""

    def __init__(self, parts: tuple):
        super().__init__()
        self.parts = nn.ModuleList(parts)

    @property
    def ne(self) -> int:
        return sum(p.ne for p in self.parts)

    def value(self, t, x, u):
        return torch.cat([p.value(t, x, u) for p in self.parts], dim=-1)

    def active(self, t: int) -> bool:
        return any(p.active(t) for p in self.parts)

    def row_mask(self, t: int) -> np.ndarray:
        """Per-row activity at step t."""
        return np.concatenate([np.full((p.ne,), p.active(t), dtype=bool) for p in self.parts])


def advance_time(constraint: nn.Module, dynamics: nn.Module, times: int = 1):
    for _ in range(times):
        constraint = AdvanceTime(inner=constraint, dynamics=dynamics)
    return constraint


@dataclasses.dataclass(frozen=True)
class EveryK:
    """Periodic schedule: active at t = offset, offset + k, offset + 2k, …"""

    k: int
    offset: int = 0

    def __contains__(self, t) -> bool:
        return t >= self.offset and (t - self.offset) % self.k == 0

    def __iter__(self):
        raise TypeError("EveryK is unbounded; iterate the horizon instead")


@dataclasses.dataclass(frozen=True)
class InRange:
    """Half-open schedule: active for begin <= t < end."""

    begin: int
    end: int

    def __contains__(self, t) -> bool:
        return self.begin <= t < self.end


def every_k(k: int, offset: int = 0) -> EveryK:
    """Schedule active every k-th step from ``offset``."""
    return EveryK(k=k, offset=offset)


def in_range(begin: int, end: int) -> InRange:
    """Schedule active on the half-open step range [begin, end)."""
    return InRange(begin=begin, end=end)
