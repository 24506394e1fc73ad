"""RobotModel (a frozen copy of the port's `models/robot_model.py`, so that
the benchmark's reference does not move when the port does): the static lumped rigid-body tree as tensors.

Every field is either a static Python tuple (tree topology, resolved in
Python while the batched ops are issued) or a tensor of numeric parameters
on one device.  A simulated model may hold one payload per scenario
(`sim.scenario.apply_payload`): then `mass`, `com` and `inertia` carry a
leading scenario axis, (B, nb), (B, nb, 3), (B, nb, 3, 3), and every other
leaf is shared.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np
import torch

# the numeric fields and the rank of each in a shared model
_TENSOR_FIELDS = dict(
    joint_R=3, joint_p=2, joint_axis=2, mass=1, com=2, inertia=3, frame_R=3, frame_p=2,
    joint_lower=1, joint_upper=1, joint_effort=1, joint_velocity=1,
)
# the fields that carry a leading scenario axis in a model per scenario
PER_SCENARIO_FIELDS = ("mass", "com", "inertia")


@dataclasses.dataclass(frozen=True)
class RobotModel:
    # -- static metadata --
    name: str
    joint_names: Tuple[str, ...]
    frame_names: Tuple[str, ...]
    parent: Tuple[int, ...]
    frame_body: Tuple[int, ...]

    # -- numeric parameters --
    joint_R: torch.Tensor     # (nj, 3, 3) joint frame rotation in parent body frame
    joint_p: torch.Tensor     # (nj, 3)    joint frame origin in parent body frame
    joint_axis: torch.Tensor  # (nj, 3)    rotation axis in joint frame
    mass: torch.Tensor        # (nb,)      (B, nb) with one model per scenario
    com: torch.Tensor         # (nb, 3)    body CoM in body frame (or (B, nb, 3))
    inertia: torch.Tensor     # (nb, 3, 3) inertia about body CoM, body frame (or (B, ...))
    frame_R: torch.Tensor     # (nf, 3, 3) frame rotation in owning body frame
    frame_p: torch.Tensor     # (nf, 3)
    joint_lower: torch.Tensor    # (nj,)
    joint_upper: torch.Tensor    # (nj,)
    joint_effort: torch.Tensor   # (nj,)
    joint_velocity: torch.Tensor  # (nj,)

    @property
    def num_bodies(self) -> int:
        return len(self.parent)

    @property
    def num_joints(self) -> int:
        return len(self.joint_names)

    @property
    def nv(self) -> int:
        """Floating-base velocity dimension: 6 + num_joints."""
        return 6 + self.num_joints

    @property
    def per_scenario(self) -> bool:
        """True where mass, com and inertia carry a leading scenario axis."""
        return self.mass.ndim > 1

    @property
    def total_mass(self) -> torch.Tensor:
        """() or, per scenario, (B,)."""
        return torch.sum(self.mass, dim=-1)

    def to(self, dtype=None, device=None) -> "RobotModel":
        return dataclasses.replace(
            self,
            **{k: getattr(self, k).to(dtype=dtype, device=device)
               for k in _TENSOR_FIELDS},
        )

    @classmethod
    def from_spec(cls, spec: dict, dtype=torch.float32,
                  device="cuda") -> "RobotModel":
        bodies = spec["bodies"]
        nb = len(bodies)
        parent = tuple(b["parent"] for b in bodies)
        for i in range(1, nb):
            if parent[i] >= i:
                raise ValueError("bodies must be topologically ordered")
        joints = [b["joint"] for b in bodies[1:]]

        def arr(x, shape=None):
            a = np.array(x, dtype=np.float64)
            if shape is not None and a.size == 0:
                a = a.reshape(shape)
            return torch.as_tensor(a, dtype=dtype, device=device)

        def lim(key, default):
            return arr([j["limit"].get(key, default) for j in joints])

        frames = spec.get("frames", [])
        return cls(
            name=spec.get("name", "robot"),
            joint_names=tuple(j["name"] for j in joints),
            frame_names=tuple(f["name"] for f in frames),
            parent=parent,
            frame_body=tuple(f["body"] for f in frames),
            joint_R=arr([j["R"] for j in joints]),
            joint_p=arr([j["p"] for j in joints]),
            joint_axis=arr([j["axis"] for j in joints]),
            mass=arr([b["mass"] for b in bodies]),
            com=arr([b["com"] for b in bodies]),
            inertia=arr([b["inertia"] for b in bodies]),
            frame_R=arr([f["R"] for f in frames], (0, 3, 3)),
            frame_p=arr([f["p"] for f in frames], (0, 3)),
            joint_lower=lim("lower", -np.inf),
            joint_upper=lim("upper", np.inf),
            joint_effort=lim("effort", np.inf),
            joint_velocity=lim("velocity", np.inf),
        )

    @classmethod
    def from_json(cls, path: str, dtype=torch.float32,
                  device="cuda") -> "RobotModel":
        with open(path) as f:
            return cls.from_spec(json.load(f), dtype=dtype, device=device)
