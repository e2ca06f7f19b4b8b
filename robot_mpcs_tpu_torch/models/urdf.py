"""Minimal URDF parser for kinematic chains.

Replaces the reference's dependency on the ``forwardkinematics`` package +
casadi symbolic FK (reference ``robotmpcs/models/mpcBase.py:46-51``) with an
in-repo parser that extracts exactly what the MPC layer needs: the joint tree
(name, type, parent, child, origin, axis, limits). Geometry/inertia/visuals are
ignored.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# Joint types that consume a configuration variable.
ACTUATED_TYPES = ("revolute", "continuous", "prismatic")


@dataclass(frozen=True)
class Joint:
    name: str
    type: str  # revolute | continuous | prismatic | fixed | floating | planar
    parent: str
    child: str
    origin_xyz: Tuple[float, float, float]
    origin_rpy: Tuple[float, float, float]
    axis: Tuple[float, float, float]
    lower: Optional[float] = None
    upper: Optional[float] = None

    @property
    def actuated(self) -> bool:
        return self.type in ACTUATED_TYPES


def _parse_vec3(s: Optional[str], default=(0.0, 0.0, 0.0)) -> Tuple[float, float, float]:
    if not s:
        return default
    vals = [float(v) for v in s.split()]
    if len(vals) != 3:
        raise ValueError(f"expected 3 floats, got {s!r}")
    return (vals[0], vals[1], vals[2])


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw to rotation matrix: R = Rz(y) @ Ry(p) @ Rx(r)."""
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def joint_origin_transform(joint: Joint) -> np.ndarray:
    """4x4 homogeneous transform of a joint's fixed <origin> element."""
    t = np.eye(4)
    t[:3, :3] = rpy_to_matrix(joint.origin_rpy)
    t[:3, 3] = joint.origin_xyz
    return t


@dataclass
class UrdfModel:
    name: str
    joints: List[Joint]
    #: child link name -> joint connecting it to its parent
    parent_joint: Dict[str, Joint] = field(default_factory=dict)
    links: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.parent_joint:
            self.parent_joint = {j.child: j for j in self.joints}
        if not self.links:
            seen = []
            for j in self.joints:
                for l in (j.parent, j.child):
                    if l not in seen:
                        seen.append(l)
            self.links = seen

    @property
    def root_link(self) -> str:
        """The unique link that is never a child of any joint."""
        children = {j.child for j in self.joints}
        roots = [l for l in self.links if l not in children]
        if len(roots) != 1:
            raise ValueError(f"expected exactly one root link, found {roots}")
        return roots[0]

    def chain_to_root(self, link: str) -> List[Joint]:
        """Joints from the tree root down to ``link`` (root-first order)."""
        chain: List[Joint] = []
        cur = link
        while cur in self.parent_joint:
            j = self.parent_joint[cur]
            chain.append(j)
            cur = j.parent
        chain.reverse()
        return chain

    def chain(self, root_link: str, end_link: str) -> List[Joint]:
        """Joints along the path root_link -> end_link.

        Only descending paths (root_link an ancestor of end_link) are
        supported; if ``root_link`` is not in the tree (the reference's
        pointRobot config names a nonexistent ``ee_link`` root,
        ``examples/config/pointRobotMpc.yaml``), the tree root is used.
        """
        if root_link not in self.links:
            root_link = self.root_link
        full = self.chain_to_root(end_link)
        if root_link == self.root_link:
            return full
        # find position of root_link along the path
        for i, j in enumerate(full):
            if j.parent == root_link:
                return full[i:]
        raise ValueError(f"{root_link} is not an ancestor of {end_link}")

    def actuated_joints(self, root_link: str, end_link: str) -> List[Joint]:
        return [j for j in self.chain(root_link, end_link) if j.actuated]

    def degrees_of_freedom(self, root_link: str, end_link: str) -> int:
        """n as computed by the reference FK package (``mpcBase.py:54-61`` uses
        ``self._fk.n()`` = number of actuated joints on the root->end chain)."""
        return len(self.actuated_joints(root_link, end_link))


def parse_urdf(urdf_text: str) -> UrdfModel:
    root = ET.fromstring(urdf_text)
    if root.tag != "robot":
        raise ValueError(f"not a URDF: root tag {root.tag!r}")
    joints: List[Joint] = []
    for el in root.findall("joint"):
        origin = el.find("origin")
        axis = el.find("axis")
        limit = el.find("limit")
        lower = upper = None
        if limit is not None:
            if limit.get("lower") is not None:
                lower = float(limit.get("lower"))
            if limit.get("upper") is not None:
                upper = float(limit.get("upper"))
        joints.append(
            Joint(
                name=el.get("name"),
                type=el.get("type"),
                parent=el.find("parent").get("link"),
                child=el.find("child").get("link"),
                origin_xyz=_parse_vec3(origin.get("xyz") if origin is not None else None),
                origin_rpy=_parse_vec3(origin.get("rpy") if origin is not None else None),
                axis=_parse_vec3(axis.get("xyz") if axis is not None else None, default=(1.0, 0.0, 0.0)),
                lower=lower,
                upper=upper,
            )
        )
    return UrdfModel(name=root.get("name", "robot"), joints=joints)


def load_urdf(path: str) -> UrdfModel:
    with open(path, "r") as f:
        return parse_urdf(f.read())
