"""Equality constraints eq(t, x, u) = 0 with dense masked schedules
(≙ ddp_tpu/ocp/constraints.py).

Protocol: ``ne`` (static width), ``value(t, x, u) -> [..., ne]`` (unmasked,
any leading batch dims) and ``active(t: int) -> bool`` (the static schedule,
read in Python for t in range(horizon)).  The problem layer multiplies values
and Jacobians by the 0/1 activity mask.
"""

from __future__ import annotations

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


def advance_time(constraint: nn.Module, dynamics: nn.Module, times: int = 1):
    for _ in range(times):
        constraint = AdvanceTime(inner=constraint, dynamics=dynamics)
    return constraint
