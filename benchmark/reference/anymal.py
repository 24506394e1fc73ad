"""ANYmal-D for the benchmark's reference: the JSON spec beside this file is a
frozen copy of the port's `models/data/anymal_d.json` (13 bodies, 12
revolute joints in the order LH, LF, RF, RH x HAA, HFE, KFE, 4 foot frames;
51.63574 kg)."""
from __future__ import annotations

import os

import torch

from benchmark.reference.robot_model import RobotModel

SPEC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "anymal_d.json")

# the reference controller's initial joint configuration
INITIAL_JOINT_POS = (
    0.0, -0.4, 0.8,
    0.0, 0.4, -0.8,
    0.0, 0.4, -0.8,
    0.0, -0.4, 0.8,
)


def anymal_d_model(dtype=torch.float64, device="cpu") -> RobotModel:
    return RobotModel.from_json(SPEC, dtype=dtype, device=device)
