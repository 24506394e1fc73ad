"""Packaged ANYmal-D model (the reference robot, urdf/anymal.urdf).

The JSON spec under `data/` is this package's own copy: 13 movable bodies
(base + 4x hip/thigh/shank), 12 revolute joints in the reference
controller's model order LH,LF,RF,RH x HAA,HFE,KFE, 4 foot frames stacked
LH,LF,RF,RH.  Total mass 51.63574 kg.
"""
from __future__ import annotations

import functools
import os

import torch

from quadrupedwholebodycontroller_tpu_torch.models.robot_model import RobotModel

_DATA = os.path.join(os.path.dirname(__file__), "data", "anymal_d.json")

# Hard-coded initial joint configuration of the reference controller
# (model order LH, LF, RF, RH x HAA, HFE, KFE).
INITIAL_JOINT_POS = (
    0.0, -0.4, 0.8,
    0.0, 0.4, -0.8,
    0.0, 0.4, -0.8,
    0.0, -0.4, 0.8,
)
INITIAL_BASE_HEIGHT = 0.60


@functools.lru_cache(maxsize=None)
def _cached(dtype: torch.dtype, device: str) -> RobotModel:
    return RobotModel.from_json(_DATA, dtype=dtype, device=device)


def anymal_d_model(dtype=torch.float32, device="cuda") -> RobotModel:
    return _cached(dtype, str(torch.device(device)))
