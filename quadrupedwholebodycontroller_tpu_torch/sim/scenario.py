"""Scenario perturbations for robustness sweeps: ground friction, a payload
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

from quadrupedwholebodycontroller_tpu_torch.models.robot_model import RobotModel
from quadrupedwholebodycontroller_tpu_torch.ops import spatial


class Scenario(NamedTuple):
    """Per-scenario world perturbation of a batch."""

    sim_friction: torch.Tensor   # (B,) ground friction coefficient
    payload_mass: torch.Tensor   # (B,) kg added rigidly to the base
    payload_com: torch.Tensor    # (B, 3) payload location in the base frame
    push_wrench: torch.Tensor    # (B, T, 6) external base wrench per control step

    @classmethod
    def nominal(cls, batch: int, T: int, friction: float = 1.0, dtype=torch.float32,
                device="cuda") -> "Scenario":
        kw = dict(dtype=dtype, device=device)
        return cls(sim_friction=torch.full((batch,), friction, **kw),
                   payload_mass=torch.zeros(batch, **kw),
                   payload_com=torch.zeros((batch, 3), **kw),
                   push_wrench=torch.zeros((batch, T, 6), **kw))

    @classmethod
    def random_batch(cls, generator: torch.Generator, batch: int, T: int,
                     dtype=torch.float32, device="cuda", friction_range=(0.5, 1.2),
                     payload_range=(0.0, 10.0), push_force: float = 60.0,
                     push_steps: int = 40) -> "Scenario":
        """The sweep distribution: friction x payload x one lateral push of
        `push_steps` control steps at a random onset in a random direction.
        Drawn in float64 on the host from `generator` (a CPU generator), then
        moved to `device`."""
        g = generator
        uni = lambda lo, hi, n=batch: lo + (hi - lo) * torch.rand(n, generator=g,
                                                                   dtype=torch.float64)
        friction = uni(*friction_range)
        payload = uni(*payload_range)
        com = torch.stack([uni(-0.15, 0.15), torch.zeros(batch, dtype=torch.float64),
                           torch.full((batch,), 0.1, dtype=torch.float64)], dim=1)
        onset = torch.randint(T // 4, max(T // 4 + 1, T - push_steps), (batch,), generator=g)
        theta = uni(0.0, 2 * math.pi)
        t_idx = torch.arange(T)[None, :]
        window = ((t_idx >= onset[:, None]) & (t_idx < onset[:, None] + push_steps)).double()
        push = torch.zeros((batch, T, 6), dtype=torch.float64)
        push[:, :, 0] = push_force * torch.cos(theta)[:, None] * window
        push[:, :, 1] = push_force * torch.sin(theta)[:, None] * window
        to = lambda t: t.to(device=device, dtype=dtype)
        return cls(sim_friction=to(friction), payload_mass=to(payload), payload_com=to(com),
                   push_wrench=to(push))


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
