"""Batch-first forward kinematics compiled from a URDF kinematic tree.

Port of ``robot_mpcs_tpu.models.fk``. The kinematic chain is resolved to a
static sequence of segments at build time (Python, once, shared with the JAX
package's design), and evaluation composes batched ``(..., 3, 3)`` rotations
and ``(..., 3)`` translations for every lane at once: ``q`` is ``(..., n)``
with any leading batch dimensions (the solver passes ``(B, N, n)``).

The JAX package needs hand-written ``custom_vmap`` batching rules
(``_walk_scalar``) because XLA lowers vmapped 3x3 products to convolutions;
in PyTorch the batched 3x3 tensor ops are the natural form and need no such
rule. The analytic geometric Jacobian (``fk_pos_links_with_jac``) replaces
forward-mode AD through the chain, as in the JAX package's ``custom_jvp``.

Configuration-vector layout (matches reference ``mpcBase.py:54-61``):

* ``holonomic``: ``q`` = the ``n`` actuated joints on the root->end chain.
* ``diffdrive``: ``q[0:3]`` = planar base pose ``(x, y, theta)`` composed as a
  world->root transform, ``q[3:]`` = actuated arm joints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from robot_mpcs_tpu_torch.models.urdf import UrdfModel, joint_origin_transform, load_urdf

# segment kinds
_FIXED = 0
_REVOLUTE = 1
_PRISMATIC = 2


def planar_base_transform(x: torch.Tensor, y: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """World->base transform of a differential-drive base, Rz(theta) at
    (x, y, 0): shape ``x.shape + (4, 4)``."""
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack(
        [
            torch.stack([c, -s, zero, x], -1),
            torch.stack([s, c, zero, y], -1),
            torch.stack([zero, zero, one, zero], -1),
            torch.stack([zero, zero, zero, one], -1),
        ],
        -2,
    )


@dataclass(frozen=True)
class _Segment:
    """One step of a compiled chain: constant pre-transform, then joint motion."""

    kind: int
    pre: np.ndarray  # (4, 4) constant transform (joint <origin>, fused fixed joints)
    axis: np.ndarray  # (3,) unit axis in the joint frame
    q_index: int  # index into q, -1 for fixed


def _compile_chain(
    model: UrdfModel,
    root_link: str,
    target_link: str,
    q_index_of_joint: Dict[str, int],
) -> List[_Segment]:
    """Compile the root->target chain into segments, fusing fixed transforms."""
    segments: List[_Segment] = []
    pending = np.eye(4)
    for joint in model.chain(root_link, target_link):
        pending = pending @ joint_origin_transform(joint)
        if not joint.actuated:
            continue
        if joint.name not in q_index_of_joint:
            raise ValueError(
                f"link {target_link!r} depends on actuated joint {joint.name!r} "
                f"that is not part of the configured root->end chain"
            )
        axis = np.asarray(joint.axis, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        kind = _PRISMATIC if joint.type == "prismatic" else _REVOLUTE
        segments.append(_Segment(kind, pending, axis, q_index_of_joint[joint.name]))
        pending = np.eye(4)
    if not np.allclose(pending, np.eye(4)):
        segments.append(_Segment(_FIXED, pending, np.zeros(3), -1))
    return segments


def _skew(axis: np.ndarray) -> np.ndarray:
    kx, ky, kz = axis
    return np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]])


class RobotKinematics:
    """Forward kinematics for one robot, compiled once per (urdf, root, end).

    Parameters mirror the reference robot config (``mpcBase.py:24-31``):
    ``root_link``/``end_link`` define the main chain (and the q layout),
    ``base_type`` selects holonomic vs diff-drive base composition.
    """

    def __init__(
        self,
        model: UrdfModel,
        root_link: str,
        end_link: str,
        base_type: str = "holonomic",
    ):
        if base_type not in ("holonomic", "diffdrive"):
            raise ValueError(f"unknown base_type {base_type!r}")
        self.model = model
        self.base_type = base_type
        # The reference's pointRobot config names a root link that does not
        # exist in the URDF; fall back to the tree root like UrdfModel.chain.
        self.root_link = root_link if root_link in model.links else model.root_link
        self.end_link = end_link
        self._base_offset = 3 if base_type == "diffdrive" else 0

        arm_joints = model.actuated_joints(self.root_link, end_link)
        self.n_arm = len(arm_joints)
        #: total configuration dimension (reference ``mpcBase.py:54-61``)
        self.n = self.n_arm + self._base_offset
        self._q_index = {
            j.name: self._base_offset + i for i, j in enumerate(arm_joints)
        }
        self._chains: Dict[str, List[_Segment]] = {}
        self._compile(end_link)
        #: joint position limits of the chain joints, shape (n_arm, 2)
        self.joint_limits = np.array(
            [
                [j.lower if j.lower is not None else -np.inf,
                 j.upper if j.upper is not None else np.inf]
                for j in arm_joints
            ]
        ).reshape(self.n_arm, 2)
        #: (dtype, device) -> per-segment constant tensors (built on first use)
        self._consts: Dict[Tuple, Dict[Tuple, Tuple[torch.Tensor, ...]]] = {}

    @classmethod
    def from_urdf_file(
        cls, path: str, root_link: str, end_link: str, base_type: str = "holonomic"
    ) -> "RobotKinematics":
        return cls(load_urdf(path), root_link, end_link, base_type)

    def _compile(self, link: str) -> List[_Segment]:
        if link not in self._chains:
            self._chains[link] = _compile_chain(
                self.model, self.root_link, link, self._q_index
            )
        return self._chains[link]

    @staticmethod
    def _seg_key(seg: _Segment):
        return (seg.kind, seg.q_index, seg.pre.tobytes(), seg.axis.tobytes())

    def _seg_consts(self, seg: _Segment, like: torch.Tensor):
        """(pre_R, pre_t, axis, K, K^2) of a segment as tensors of ``like``'s
        dtype and device, copied to the device once and cached."""
        table = self._consts.setdefault((like.dtype, like.device), {})
        key = self._seg_key(seg)
        if key not in table:
            K = _skew(seg.axis)
            table[key] = tuple(
                torch.as_tensor(v, dtype=like.dtype, device=like.device)
                for v in (seg.pre[:3, :3], seg.pre[:3, 3], seg.axis, K, K @ K)
            )
        return table[key]

    def _base_rp(self, q: torch.Tensor):
        """(R, p) of the world->root transform, shapes (..., 3, 3) and (..., 3)."""
        bshape = q.shape[:-1]
        if self.base_type == "diffdrive":
            t = planar_base_transform(q[..., 0], q[..., 1], q[..., 2])
            return t[..., :3, :3], t[..., :3, 3]
        R = torch.eye(3, dtype=q.dtype, device=q.device).expand(bshape + (3, 3))
        return R, torch.zeros(bshape + (3,), dtype=q.dtype, device=q.device)

    def _step(self, R, p, seg: _Segment, q, recs=None):
        """Compose one segment onto (R, p); with ``recs`` (a tuple), also
        append the joint record (q_index, kind, origin, world axis) the
        analytic Jacobian needs."""
        pre_R, pre_t, axis, K, K2 = self._seg_consts(seg, q)
        # T <- T @ pre
        p = p + R @ pre_t
        R = R @ pre_R
        if seg.kind == _REVOLUTE:
            if recs is not None:
                recs = recs + ((seg.q_index, _REVOLUTE, p, R @ axis),)
            qj = q[..., seg.q_index, None, None]
            # Rodrigues: R_axis = I + sin(q) K + (1 - cos(q)) K^2
            Ra = torch.eye(3, dtype=q.dtype, device=q.device) + torch.sin(qj) * K + (
                1.0 - torch.cos(qj)
            ) * K2
            R = R @ Ra
        elif seg.kind == _PRISMATIC:
            w = R @ axis
            if recs is not None:
                recs = recs + ((seg.q_index, _PRISMATIC, p, w),)
            p = p + w * q[..., seg.q_index, None]
        return R, p, recs

    def _walk_links(self, q: torch.Tensor, links: Sequence[str], want_jac: bool):
        """Shared-prefix walk over several links (serial-arm collision links
        all lie on the root->end path, so the set costs one walk of the
        longest chain). Returns per-link (R, p, joint records)."""
        R0, p0 = self._base_rp(q)
        cache = {(): (R0, p0, () if want_jac else None)}
        out = []
        for link in links:
            key = ()
            R, p, recs = cache[()]
            for seg in self._compile(link):
                new_key = key + (self._seg_key(seg),)
                if new_key not in cache:
                    cache[new_key] = self._step(R, p, seg, q, recs)
                R, p, recs = cache[new_key]
                key = new_key
            out.append((R, p, recs))
        return out

    def fk_frame(self, q: torch.Tensor, link: Optional[str] = None) -> torch.Tensor:
        """Homogeneous transform root->link, shape ``(..., 4, 4)``."""
        (R, p, _), = self._walk_links(q, [link or self.end_link], False)
        bottom = torch.zeros(q.shape[:-1] + (1, 4), dtype=q.dtype, device=q.device)
        bottom[..., 0, 3] = 1.0
        return torch.cat([torch.cat([R, p[..., None]], -1), bottom], -2)

    def fk_pos(self, q: torch.Tensor, link: Optional[str] = None) -> torch.Tensor:
        """Position of ``link`` in the root frame, shape (..., 3)
        (the reference's ``fk(..., positionOnly=True)[0:3]``, mpcBase.py:89-94)."""
        return self.fk_pos_links(q, [link or self.end_link])[..., 0, :]

    def fk_pos_links(self, q: torch.Tensor, links: Sequence[str]) -> torch.Tensor:
        """Stacked positions for several links, shape (..., len(links), 3)."""
        return torch.stack([p for _, p, _ in self._walk_links(q, links, False)], -2)

    def fk_pos_links_with_jac(self, q: torch.Tensor, links: Sequence[str]):
        """(positions (..., L, 3), geometric Jacobian (..., L, 3, n)) in one walk.

        A revolute joint j with world axis w_j and origin o_j moves a
        downstream point p by ``w_j x (p - o_j)`` per radian; a prismatic
        joint by ``w_j``; a diff-drive base contributes identity columns for
        (x, y) and ``z x (p - base)`` for theta (``fk.py:227-275`` of the JAX
        package).
        """
        zero = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
        P_rows, J_rows = [], []
        for _, p, recs in self._walk_links(q, links, want_jac=True):
            cols = [zero] * self.n
            if self.base_type == "diffdrive":
                ex = torch.zeros_like(zero)
                ex[..., 0] = 1.0
                ey = torch.zeros_like(zero)
                ey[..., 1] = 1.0
                d = p - torch.stack([q[..., 0], q[..., 1], zero[..., 0]], -1)
                # z x d = (-d_y, d_x, 0)
                cols[0], cols[1] = ex, ey
                cols[2] = torch.stack([-d[..., 1], d[..., 0], zero[..., 0]], -1)
            for q_index, kind, origin, w in recs:
                cols[q_index] = (
                    torch.linalg.cross(w, p - origin, dim=-1) if kind == _REVOLUTE else w
                )
            P_rows.append(p)
            J_rows.append(torch.stack(cols, dim=-1))  # (..., 3, n)
        return torch.stack(P_rows, -2), torch.stack(J_rows, -3)
