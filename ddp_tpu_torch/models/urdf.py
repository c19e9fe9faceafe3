"""URDF → RobotModel loader (≙ ddp_tpu/models/urdf.py).

≙ the reference's URDF model builder, which delegates to urdfdom.  Two
parse backends produce identical raw records:

- native: the C++ scanner of ``cpp/ddp_runtime.cpp`` through ctypes
  (``utils/native.py``, built on demand);
- python: a small ``xml.etree`` pass (always available; ``backend="auto"``
  falls back to it when the native library cannot be built).

Tree assembly is shared: fixed joints fold their subtree's link inertia into
the parent body (a spatial-inertia transform) and register the child link
as a frame, so end-effector frames declared through fixed joints work as
constraint targets.  The accumulated spatial inertias are handed to
``build_model`` directly.

Supported joints: revolute, continuous, prismatic, fixed, floating, planar.
``<limit>`` elements fill RobotModel.q_lower/q_upper/v_limit/tau_limit;
``<mimic>`` joints reduce the model to a ReducedModel (models/reduced.py)
with the slaved coordinates eliminated.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from ddp_tpu_torch.models.rigid_body import RobotModel, build_model, spatial_inertia, xmat

_JOINT_MAP = {
    "revolute": "revolute",
    "continuous": "continuous",
    "prismatic": "prismatic",
    "floating": "freeflyer",
    "planar": "planar",
}


def _rpy_to_mat(r, p, y):
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


# ---------------------------------------------------------------------------
# raw-record extraction (two backends, one record format)
# ---------------------------------------------------------------------------


def _records_from_etree(root) -> dict:
    def parse_origin(el):
        if el is None:
            return np.zeros(3), np.zeros(3)
        xyz = np.array([float(v) for v in el.get("xyz", "0 0 0").split()])
        rpy = np.array([float(v) for v in el.get("rpy", "0 0 0").split()])
        return xyz, rpy

    joints = root.findall("joint")
    links = root.findall("link")
    rec = dict(
        robot_name=root.get("name", "urdf_robot"),
        joint_names=[], joint_types=[], joint_parents=[], joint_children=[],
        joint_origin=np.zeros((len(joints), 6)),
        joint_axis=np.zeros((len(joints), 3)),
        joint_limits=[],
        joint_mimic=[],
        link_names=[],
        link_inertial=np.zeros((len(links), 13)),
    )  # fmt: skip
    for i, j in enumerate(joints):
        rec["joint_names"].append(j.get("name", ""))
        rec["joint_types"].append(j.get("type", "fixed"))
        rec["joint_parents"].append(j.find("parent").get("link"))
        rec["joint_children"].append(j.find("child").get("link"))
        xyz, rpy = parse_origin(j.find("origin"))
        rec["joint_origin"][i, :3], rec["joint_origin"][i, 3:] = xyz, rpy
        axis_el = j.find("axis")
        rec["joint_axis"][i] = (
            np.array([float(v) for v in axis_el.get("xyz").split()])
            if axis_el is not None
            else np.array([0.0, 0.0, 1.0])
        )
        lim_el = j.find("limit")
        rec["joint_limits"].append(
            None
            if lim_el is None
            else {
                k: float(lim_el.get(k))
                for k in ("lower", "upper", "velocity", "effort")
                if lim_el.get(k) is not None
            }
        )
        mim_el = j.find("mimic")
        rec["joint_mimic"].append(
            None
            if mim_el is None
            else {
                "joint": mim_el.get("joint"),
                "multiplier": float(mim_el.get("multiplier", "1")),
                "offset": float(mim_el.get("offset", "0")),
            }
        )
    for i, link in enumerate(links):
        rec["link_names"].append(link.get("name", ""))
        inertial = link.find("inertial")
        if inertial is None:
            continue
        mass_el = inertial.find("mass")
        rec["link_inertial"][i, 0] = float(mass_el.get("value")) if mass_el is not None else 0.0
        xyz, rpy = parse_origin(inertial.find("origin"))
        rec["link_inertial"][i, 1:4], rec["link_inertial"][i, 4:7] = xyz, rpy
        it = inertial.find("inertia")
        if it is not None:
            rec["link_inertial"][i, 7:13] = [
                float(it.get(k, "0")) for k in ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")
            ]
    return rec


def _records(xml_text: str, backend: str) -> dict:
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown URDF backend {backend!r}; have ('auto', 'native', 'python')")
    if backend in ("auto", "native"):
        try:
            from ddp_tpu_torch.utils.native import parse_urdf_native

            rec = parse_urdf_native(xml_text)
            if rec is not None:
                return rec
            if backend == "native":
                raise RuntimeError("native runtime unavailable")
        except Exception:
            if backend == "native":
                raise
    return _records_from_etree(ET.fromstring(xml_text))


# ---------------------------------------------------------------------------
# tree assembly
# ---------------------------------------------------------------------------


def load_urdf(
    path_or_string: str,
    *,
    root_joint: str | None = None,
    device: torch.device | str,
    dtype: torch.dtype,
    backend: str = "auto",
) -> RobotModel:
    """Parse a URDF file path or XML string into a RobotModel (a
    ReducedModel when the URDF has mimic joints) on ``device`` in ``dtype``.

    ``root_joint="freeflyer"`` inserts a floating base.  ``backend``:
    "auto" (native with the Python fallback), "native" (raises when the
    native library is unavailable) or "python".
    """
    if "<robot" in path_or_string:
        xml_text = path_or_string
    else:
        with open(path_or_string) as f:
            xml_text = f.read()
    rec = _records(xml_text, backend)

    n_joints = len(rec["joint_names"])
    limits = rec.get("joint_limits") or [None] * n_joints
    mimics = rec.get("joint_mimic") or [None] * n_joints

    link_idx = {n: i for i, n in enumerate(rec["link_names"])}
    children: dict[str, list[int]] = {}
    child_links = set()
    for i, parent in enumerate(rec["joint_parents"]):
        children.setdefault(parent, []).append(i)
        child_links.add(rec["joint_children"][i])
    roots = [n for n in rec["link_names"] if n not in child_links]
    if len(roots) != 1:
        raise ValueError(f"expected one root link, found {roots}")
    root_link = roots[0]

    model_joints: list[dict] = []
    frames: list[dict] = []

    def add_link_inertia(body_idx, R_bl, p_bl, link_name):
        if body_idx < 0:
            return
        row = rec["link_inertial"][link_idx[link_name]]
        mass = row[0]
        if mass == 0.0:
            return
        com_p, com_rpy = row[1:4], row[4:7]
        ixx, ixy, ixz, iyy, iyz, izz = row[7:13]
        inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        R_i = _rpy_to_mat(*com_rpy)
        I_com = R_i @ inertia @ R_i.T  # inertia tensor in the link frame
        I_link = spatial_inertia(mass, com_p, I_com).numpy()
        # body→link motion transform; I_b += Xᵀ I_l X
        X = xmat(torch.as_tensor(R_bl.T), torch.as_tensor(p_bl)).numpy()
        j = model_joints[body_idx]
        j["spatial_inertia"] = j["spatial_inertia"] + X.T @ I_link @ X

    def walk(link_name: str, body_idx: int, R_bl, p_bl):
        add_link_inertia(body_idx, R_bl, p_bl, link_name)
        for ji in children.get(link_name, []):
            jtype = rec["joint_types"][ji]
            child = rec["joint_children"][ji]
            xyz, rpy = rec["joint_origin"][ji, :3], rec["joint_origin"][ji, 3:]
            R_o, p_o = _rpy_to_mat(*rpy), xyz
            # joint frame pose in the parent *body* frame
            R_jb = R_bl @ R_o
            p_jb = R_bl @ p_o + p_bl
            if jtype == "fixed":
                frames.append(dict(name=child, body=body_idx, rot=R_jb, trans=p_jb))
                walk(child, body_idx, R_jb, p_jb)
            else:
                model_joints.append(
                    dict(
                        type=_JOINT_MAP[jtype],
                        parent=body_idx,
                        placement_rot=R_jb.T,  # parent-body coords → joint coords
                        placement_trans=p_jb,
                        axis=rec["joint_axis"][ji],
                        spatial_inertia=np.zeros((6, 6)),
                        name=rec["joint_names"][ji],
                        limit=limits[ji],
                        mimic=mimics[ji],
                    )
                )
                new_idx = len(model_joints) - 1
                frames.append(dict(name=child, body=new_idx, rot=np.eye(3), trans=np.zeros(3)))
                walk(child, new_idx, np.eye(3), np.zeros(3))

    if root_joint is not None:
        model_joints.append(
            dict(
                type="freeflyer" if root_joint == "floating" else root_joint,
                parent=-1,
                spatial_inertia=np.zeros((6, 6)),
                name="root_joint",
            )
        )
        walk(root_link, 0, np.eye(3), np.zeros(3))
    else:
        walk(root_link, -1, np.eye(3), np.zeros(3))

    if not model_joints:
        raise ValueError("URDF contains no movable joints")

    model = build_model(
        model_joints, frames=frames, name=rec["robot_name"], device=device, dtype=dtype
    )

    # mimic joints → reduced-coordinate wrapper (models/reduced.py)
    mimic_specs = {}
    name_to_idx = {j.get("name"): i for i, j in enumerate(model_joints)}
    for i, j in enumerate(model_joints):
        spec = j.get("mimic")
        if spec is None:
            continue
        master = name_to_idx.get(spec["joint"])
        if master is None:
            raise ValueError(f"mimic master joint {spec['joint']!r} is not a movable joint")
        mimic_specs[i] = (master, spec["multiplier"], spec["offset"])
    if mimic_specs:
        from ddp_tpu_torch.models.reduced import reduce_mimic

        for m, _, _ in mimic_specs.values():
            if m in mimic_specs:
                raise ValueError("chained mimic joints are not supported")
        masters = [i for i in range(len(model_joints)) if i not in mimic_specs]
        return reduce_mimic(model, masters, mimic_specs)
    return model
