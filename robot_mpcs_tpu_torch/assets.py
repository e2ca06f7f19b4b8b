"""Built-in robot descriptions, authored as kinematic data.

Instead of shipping URDF files, the three canonical robots of the reference
framework (pointRobot / panda / boxer, reference ``examples/assets/``) are
described here as joint tables built from their public kinematic parameters
(the panda values are the standard Franka Emika Panda DH-derived joint
origins). ``write_urdf`` can emit a URDF file for interop with URDF-consuming
tools, and ``builtin_model`` returns the parsed ``UrdfModel`` directly.
"""

from __future__ import annotations

import math
from typing import Dict, List

from robot_mpcs_tpu_torch.models.urdf import Joint, UrdfModel

_HALF_PI = math.pi / 2.0


def _point_robot_joints() -> List[Joint]:
    # A planar holonomic point mass: prismatic x, prismatic y, yaw.
    # Matches the reference pointRobot kinematics (3 dof, base at z=0.05).
    return [
        Joint("mobile_joint_x", "prismatic", "world", "base_link_x",
              (0.0, 0.0, 0.05), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), -5.0, 5.0),
        Joint("mobile_joint_y", "prismatic", "base_link_x", "base_link_y",
              (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), -5.0, 5.0),
        Joint("mobile_joint_theta", "revolute", "base_link_y", "base_link",
              (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), -5.0, 5.0),
        Joint("ee_joint", "fixed", "base_link", "ee_link",
              (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
    ]


def _panda_joints() -> List[Joint]:
    # Franka Emika Panda arm, 7 revolute joints, all about local z.
    # (xyz, rpy) per joint are the public flange kinematic parameters.
    params = [
        ((0.0, 0.0, 0.333), (0.0, 0.0, 0.0), (-2.8973, 2.8973)),
        ((0.0, 0.0, 0.0), (-_HALF_PI, 0.0, 0.0), (-1.7628, 1.7628)),
        ((0.0, -0.316, 0.0), (_HALF_PI, 0.0, 0.0), (-2.8973, 2.8973)),
        ((0.0825, 0.0, 0.0), (_HALF_PI, 0.0, 0.0), (-3.0718, 0.0698)),
        ((-0.0825, 0.384, 0.0), (-_HALF_PI, 0.0, 0.0), (-2.8973, 2.8973)),
        ((0.0, 0.0, 0.0), (_HALF_PI, 0.0, 0.0), (-0.0175, 3.7525)),
        ((0.088, 0.0, 0.0), (_HALF_PI, 0.0, 0.0), (-2.8973, 2.8973)),
    ]
    joints = [
        Joint("panda_joint_world", "fixed", "world", "panda_link0",
              (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0))
    ]
    for i, (xyz, rpy, (lo, hi)) in enumerate(params, start=1):
        joints.append(
            Joint(f"panda_joint{i}", "revolute", f"panda_link{i-1}",
                  f"panda_link{i}", xyz, rpy, (0.0, 0.0, 1.0), lo, hi)
        )
    return joints


def _boxer_joints() -> List[Joint]:
    # Differential-drive base; the MPC only needs base_link -> ee_link
    # (lidar mount point 0.4 m ahead of the base center).
    return [
        Joint("base_chassis_joint", "fixed", "base_link", "chassis_link",
              (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
        Joint("ee_joint", "fixed", "base_link", "ee_link",
              (0.4, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
    ]


_BUILDERS = {
    "pointRobot": _point_robot_joints,
    "panda": _panda_joints,
    "boxer": _boxer_joints,
}


def builtin_model(name: str) -> UrdfModel:
    """Return the built-in kinematic model for 'pointRobot' | 'panda' | 'boxer'."""
    if name not in _BUILDERS:
        raise KeyError(f"unknown builtin robot {name!r}; have {sorted(_BUILDERS)}")
    return UrdfModel(name=name, joints=_BUILDERS[name]())


def to_urdf_xml(model: UrdfModel) -> str:
    """Serialize a joint-table model to URDF XML (kinematics only)."""
    lines = [f'<?xml version="1.0"?>', f'<robot name="{model.name}">']
    for link in model.links:
        lines.append(f'  <link name="{link}"/>')
    for j in model.joints:
        lines.append(f'  <joint name="{j.name}" type="{j.type}">')
        lines.append(f'    <parent link="{j.parent}"/>')
        lines.append(f'    <child link="{j.child}"/>')
        xyz = " ".join(repr(v) for v in j.origin_xyz)
        rpy = " ".join(repr(v) for v in j.origin_rpy)
        lines.append(f'    <origin xyz="{xyz}" rpy="{rpy}"/>')
        if j.actuated:
            axis = " ".join(repr(v) for v in j.axis)
            lines.append(f'    <axis xyz="{axis}"/>')
            if j.lower is not None and j.upper is not None:
                lines.append(f'    <limit lower="{j.lower}" upper="{j.upper}" effort="100" velocity="10"/>')
        lines.append("  </joint>")
    lines.append("</robot>")
    return "\n".join(lines) + "\n"


def write_urdf(name: str, path: str) -> str:
    """Emit a built-in robot as a URDF file; returns the path."""
    with open(path, "w") as f:
        f.write(to_urdf_xml(builtin_model(name)))
    return path


#: robot-name -> (root_link, end_link, base_type) as configured by the
#: reference example configs (examples/config/*.yaml).
BUILTIN_FRAMES: Dict[str, tuple] = {
    "pointRobot": ("world", "base_link", "holonomic"),
    "panda": ("panda_link0", "panda_link7", "holonomic"),
    "boxer": ("base_link", "ee_link", "diffdrive"),
}
