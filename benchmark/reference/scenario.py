"""(The benchmark's reference: a frozen copy of the port's `sim/scenario.py`.)

Scenario perturbations for robustness sweeps: ground friction, a payload
on the base, and a push (one lateral force window) per scenario.

The payload changes the simulated robot only; the controller keeps the
nominal model (model-mismatch robustness, the realistic condition).  A
sweep simulates one payload model per scenario (`apply_payload` on the
batch's payloads)."""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from benchmark.reference.robot_model import RobotModel
from benchmark.reference import spatial


def apply_payload(model: RobotModel, payload_mass, payload_com) -> RobotModel:
    """The model with a rigid point payload (mass payload_mass at
    payload_com, base frame) lumped into the base body: its mass, centre of
    mass and inertia about the new centre of mass.  A scalar payload_mass
    and payload_com (3,) give a shared model; payload_mass (B,) and
    payload_com (B, 3) give one model per scenario, whose mass, com and
    inertia are (B, nb), (B, nb, 3), (B, nb, 3, 3) (`model.per_scenario`),
    every other leaf shared."""
    kw = dict(dtype=model.mass.dtype, device=model.mass.device)
    pm, pc = torch.as_tensor(payload_mass, **kw), torch.as_tensor(payload_com, **kw)
    lead = pm.shape
    m0, c0 = model.mass[0], model.com[0]
    m = m0 + pm
    c = (m0 * c0 + pm[..., None] * pc) / m[..., None]
    S0 = spatial.skew(c0 - c)
    Sp = spatial.skew(pc - c)
    I_new = model.inertia[0] - m0 * (S0 @ S0) - pm[..., None, None] * (Sp @ Sp)
    rest = lambda leaf: leaf[1:].expand(lead + leaf[1:].shape)
    return dataclasses.replace(
        model,
        mass=torch.cat([m[..., None], rest(model.mass)], dim=-1),
        com=torch.cat([c[..., None, :], rest(model.com)], dim=-2),
        inertia=torch.cat([I_new[..., None, :, :], rest(model.inertia)], dim=-3),
    )
