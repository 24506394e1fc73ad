"""Traffic generators: each reads a traffic file's parameters
(`benchmark/traffic/<name>.json`, its "generator" key names the function
here) and the seed, and makes the same inputs for the same seed.

replay   a recorded 400 Hz trajectory (`benchmark/recordings/`) broadcast
         to B scenarios: recording profile p = scenario mod P, an optional
         phase offset in whole planner periods, and constant per-scenario
         state offsets (normal, the traffic's sigmas)
episode  a robustness-sweep episode: forward-speed commands and one
         Scenario draw per robot (friction, payload, push)
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OBS_KEYS = ("base_R", "base_p", "base_vel", "q", "qd")
REF_KEYS = ("com_pose", "com_vel", "com_acc", "swing_pos", "swing_vel", "swing_acc",
            "contacts")
PLANNER_PERIOD = 4   # control steps a recorded planner period spans


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """One numpy generator per purpose, all from the run's seed (any
    non-negative integer, also beyond 32 bits)."""
    return np.random.default_rng([int(seed) & (2**63 - 1), sum(map(ord, stream))])


class Replay:
    """The replay traffic of B scenarios.  `step(t)` gives recorded step t
    mod T of every scenario as numpy arrays: (obs dict, ref dict, ref_is_new
    (B,) bool); `period` is T."""

    def __init__(self, spec: dict, batch: int, seed: int):
        data = np.load(os.path.join(HERE, "recordings", spec["recording"]))
        tables = {k: data[k] for k in OBS_KEYS + REF_KEYS + ("ref_is_new",)}
        if tables["ref_is_new"].ndim == 1:              # one profile
            tables = {k: v[None] for k, v in tables.items()}
        self.tables = tables
        profiles, self.period = tables["ref_is_new"].shape
        rng = rng_for(seed, "replay")
        self.profile = np.arange(batch) % profiles
        self.offset = (PLANNER_PERIOD * rng.integers(0, self.period // PLANNER_PERIOD, batch)
                       if spec["phase_offsets"] else np.zeros(batch, dtype=np.int64))
        width = {k: tables[k].shape[-1] for k in spec["offset_sigma"]}
        self.state_offset = {k: (s * rng.standard_normal((batch, width[k]))).astype(np.float32)
                             for k, s in spec["offset_sigma"].items()}
        self.synchronous = not spec["phase_offsets"]

    def step(self, t: int):
        idx = (self.profile, (t + self.offset) % self.period)
        obs = {k: self.tables[k][idx] + self.state_offset.get(k, 0.0) for k in OBS_KEYS}
        ref = {k: self.tables[k][idx] for k in REF_KEYS}
        return obs, ref, self.tables["ref_is_new"][idx]


def replay(spec: dict, batch: int, seed: int) -> Replay:
    return Replay(spec, batch, seed)


class Episode:
    """One sweep episode of B robots over T control steps, drawn as the
    port's CLI sweep draws it: forward speed U(0, speed_max) from control
    step `speed_from_step`; friction U(friction); payload U(payload_kg) at
    x U(-payload_x, payload_x), z payload_z; one push of push_force_N for
    push_steps control steps from an onset U[T/4, T - push_steps), in a
    direction U(0, 2 pi).  Everything float64 numpy."""

    def __init__(self, spec: dict, batch: int, seed: int):
        T = spec["episode_steps"]
        rng = rng_for(seed, "episode")
        uni = lambda lo, hi, n=batch: lo + (hi - lo) * rng.random(n)
        self.gait, self.steps = spec["gait"], T
        self.commands = np.zeros((batch, T, 3))
        self.commands[:, spec["speed_from_step"]:, 0] = uni(0.0, spec["speed_max"])[:, None]
        self.friction = uni(*spec["friction"])
        self.payload_mass = uni(*spec["payload_kg"])
        self.payload_com = np.stack([uni(-spec["payload_x"], spec["payload_x"]),
                                     np.zeros(batch), np.full(batch, spec["payload_z"])], 1)
        n_push = spec["push_steps"]
        onset = rng.integers(T // 4, max(T // 4 + 1, T - n_push), batch)
        theta = uni(0.0, 2 * math.pi)
        t = np.arange(T)[None, :]
        window = ((t >= onset[:, None]) & (t < onset[:, None] + n_push)).astype(np.float64)
        self.push = np.zeros((batch, T, 6))
        self.push[:, :, 0] = spec["push_force_N"] * np.cos(theta)[:, None] * window
        self.push[:, :, 1] = spec["push_force_N"] * np.sin(theta)[:, None] * window


def episode(spec: dict, batch: int, seed: int) -> Episode:
    return Episode(spec, batch, seed)


def make(spec: dict, batch: int, seed: int):
    """The generator a traffic file names, on its parameters."""
    return {"replay": replay, "episode": episode}[spec["generator"]](spec, batch, seed)


def to_torch(tree: dict, dtype, device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device).to(dtype)
            for k, v in tree.items()}
