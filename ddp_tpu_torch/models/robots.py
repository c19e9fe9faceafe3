"""Built-in robot constructors (≙ ddp_tpu/models/robots.py)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ddp_tpu_torch.models.rigid_body import (
    RobotModel,
    all_joints_test_model,
    build_model,
    double_pendulum,
)
from ddp_tpu_torch.models.urdf import load_urdf

ASSETS = Path(__file__).resolve().parent / "assets"


def ur5(*, device: torch.device | str, dtype: torch.dtype) -> RobotModel:
    """6-DoF UR5 arm from the bundled URDF (``assets/ur5.urdf``)."""
    return load_urdf(str(ASSETS / "ur5.urdf"), device=device, dtype=dtype)


def panda7(*, device: torch.device | str, dtype: torch.dtype) -> RobotModel:
    """7-DoF Panda-class arm ("equality-constrained DDP on a 7-DoF arm").
    Kinematic layout follows the Franka Panda joint arrangement (alternating
    z/y axes with elbow offsets); inertial values are representative link
    masses/inertias."""
    d1, d3, d5, a4, a7 = 0.333, 0.316, 0.384, 0.0825, 0.107
    joints = [
        dict(type="revolute", parent=-1, placement_trans=[0, 0, d1], axis=[0, 0, 1],
             mass=3.5, com=[0, -0.03, -0.08], inertia=np.diag([0.02, 0.02, 0.008])),
        dict(type="revolute", parent=0, axis=[0, 1, 0],
             mass=3.5, com=[0, -0.07, 0.03], inertia=np.diag([0.02, 0.018, 0.008])),
        dict(type="revolute", parent=1, placement_trans=[0, 0, d3], axis=[0, 0, 1],
             mass=2.5, com=[0.04, 0.02, -0.05], inertia=np.diag([0.01, 0.01, 0.006])),
        dict(type="revolute", parent=2, placement_trans=[a4, 0, 0], axis=[0, -1, 0],
             mass=2.5, com=[-0.04, 0.05, 0.02], inertia=np.diag([0.01, 0.009, 0.006])),
        dict(type="revolute", parent=3, placement_trans=[-a4, 0, d5], axis=[0, 0, 1],
             mass=1.8, com=[0, 0.03, -0.1], inertia=np.diag([0.008, 0.008, 0.004])),
        dict(type="revolute", parent=4, axis=[0, -1, 0],
             mass=1.5, com=[0.06, -0.02, 0.01], inertia=np.diag([0.004, 0.004, 0.002])),
        dict(type="revolute", parent=5, placement_trans=[0.088, 0, 0], axis=[0, 0, -1],
             mass=0.8, com=[0, 0, 0.06], inertia=np.diag([0.002, 0.002, 0.001])),
    ]  # fmt: skip
    frames = [dict(name="ee", body=6, trans=[0.0, 0.0, a7])]
    return build_model(joints, frames=frames, name="panda7", device=device, dtype=dtype)


def cartpole(*, device: torch.device | str, dtype: torch.dtype) -> RobotModel:
    """Prismatic cart + revolute pole (classic underactuated benchmark)."""
    joints = [
        dict(type="prismatic", parent=-1, axis=[1, 0, 0],
             mass=1.0, com=[0, 0, 0], inertia=np.diag([1e-4, 1e-4, 1e-4])),
        dict(type="revolute", parent=0, axis=[0, 1, 0],
             mass=0.3, com=[0.0, 0.0, 0.5], inertia=np.diag([1e-4, 1e-4, 1e-5])),
    ]  # fmt: skip
    frames = [dict(name="tip", body=1, trans=[0.0, 0.0, 1.0])]
    return build_model(joints, frames=frames, name="cartpole", device=device, dtype=dtype)


def acrobot(*, device: torch.device | str, dtype: torch.dtype) -> RobotModel:
    """Double pendulum actuated only at the elbow (set damping/torque
    masking at the problem layer; the model itself is the double pendulum
    with standard acrobot inertias)."""
    joints = [
        dict(type="revolute", parent=-1, axis=[0, 1, 0],
             mass=1.0, com=[0, 0, -0.5], inertia=np.diag([0.083, 0.083, 1e-4])),
        dict(type="revolute", parent=0, placement_trans=[0, 0, -1.0], axis=[0, 1, 0],
             mass=1.0, com=[0, 0, -0.5], inertia=np.diag([0.083, 0.083, 1e-4])),
    ]  # fmt: skip
    frames = [dict(name="tip", body=1, trans=[0.0, 0.0, -1.0])]
    return build_model(joints, frames=frames, name="acrobot", device=device, dtype=dtype)


def quadrotor(*, device: torch.device | str, dtype: torch.dtype) -> RobotModel:
    """Free-flying rigid body (quadrotor-class): one freeflyer joint; the
    control map (rotor forces → wrench) lives at the problem layer."""
    joints = [
        dict(type="freeflyer", parent=-1,
             mass=1.0, com=[0, 0, 0], inertia=np.diag([0.01, 0.01, 0.02])),
    ]  # fmt: skip
    frames = [dict(name="base", body=0, trans=[0.0, 0.0, 0.0])]
    return build_model(joints, frames=frames, name="quadrotor", device=device, dtype=dtype)


def ee_frame_id(model: RobotModel, name: str = "ee_link") -> int:
    return model.frame_names.index(name)


__all__ = [
    "all_joints_test_model",
    "build_model",
    "double_pendulum",
    "ur5",
    "panda7",
    "cartpole",
    "acrobot",
    "quadrotor",
    "ee_frame_id",
    "load_urdf",
]
