"""The control-step cells (configuration entry "wbc_step").

The timed path is the port's batched 400 Hz control cycle,
`control.wbc.wbc_step_batched(qp_backend="kernel", setup_backend="auto")`
with a carried QPCache, on B scenarios of a replay traffic.  The carry and
the cache are threaded through the whole run, pass after pass of the
recording.  Every step is timed on the host clock and ends in
`torch.cuda.synchronize()`: a 400 Hz loop needs each step's torques.

Set-up makes every pass's inputs on the card, then runs one whole pass:
the cold first step, the warm steps, the contact switches with their cold
fixes, the drop rounds and the rescues.  The window keeps stepping until
`seconds` have passed.  One pass of the window, drawn from the seed, is
kept for the check: every scenario's (x, y, tau) and its flag at each of
its steps.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generate
from benchmark.reference import anymal as ref_anymal
from benchmark.reference import wbc as ref_wbc

# passes of the window among which the checked one is drawn
CHECK_PASSES = 2
# reference steps run before the checked pass: its carry then matches the
# program's (two planner messages and the finite differences' two steps)
REF_LEAD = 40
TRACED_STEPS = 5    # steps of a --trace 1 run's traced segment


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from quadrupedwholebodycontroller_tpu_torch.config import (
            QP_NUM_CONSTRAINTS, QP_NUM_VARS, ControllerParams, QPSolverParams)
        from quadrupedwholebodycontroller_tpu_torch.control import wbc
        from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
        from quadrupedwholebodycontroller_tpu_torch.ops import qp

        self.config, self.device, self.seed = config, device, seed
        self.B = config["batch"]
        self.dtype = getattr(torch, config["dtype"])
        self.wbc, self.qp = wbc, qp
        self.model = anymal_d_model(self.dtype, device)
        self.cp = ControllerParams(**_hashable(config["controller"]))
        self.qpp = QPSolverParams(**config["qp_solver"])
        self.flag_threshold = self.qpp.rescue_threshold
        self.traffic = generate.make(traffic, self.B, seed)
        self.period = self.traffic.period
        self.inputs = [self._inputs(t) for t in range(self.period)]
        self.carry = wbc.init_carry(self.B, self.dtype, device)
        self.cache = qp.make_cache(self.B, QP_NUM_VARS, QP_NUM_CONSTRAINTS, self.qpp,
                                   self.dtype, device)
        self.steps_done = 0
        self.checked_pass = 1 + int(generate.rng_for(seed, "check").integers(CHECK_PASSES))
        self.kept = {}
        for _ in range(self.period):      # the warm-up pass
            self.step()

    def _inputs(self, t: int):
        obs, ref, new = self.traffic.step(t)
        obs = self.wbc.RobotObservation(**generate.to_torch(obs, self.dtype, self.device))
        ref = self.wbc.Reference(**generate.to_torch(ref, self.dtype, self.device))
        new = bool(new[0]) if self.traffic.synchronous else torch.as_tensor(
            new, device=self.device)
        return obs, ref, new

    def step(self):
        """One control step of the batch: the timed call and nothing else."""
        obs, ref, new = self.inputs[self.steps_done % self.period]
        out, self.carry, self.cache = self.wbc.wbc_step_batched(
            self.model, self.cp, self.qpp, obs, ref, self.carry, new, "kernel", self.cache,
            self.steps_done > 0)
        self.steps_done += 1
        return out

    def _keep(self, out):
        g = self.steps_done - 1
        if g // self.period == self.checked_pass:
            self.kept[g] = (out.qp_x.clone(), self.carry.qp_warm.y.clone(), out.tau.clone(),
                            out.qp_info.kkt_residual.clone())

    def window(self, seconds: float, sync, segment=None, spy=None):
        """Step until `seconds` have passed; returns the window's record.
        With a trace `segment`, TRACED_STEPS further steps are traced once
        the window has closed, with the launch records of `spy`."""
        step_ms, kkts, taus = [], [], []
        t_start = time.perf_counter()
        while True:
            sync()
            t0 = time.perf_counter()
            out = self.step()
            sync()
            t1 = time.perf_counter()
            step_ms.append((t1 - t0) * 1e3)
            kkts.append(out.qp_info.kkt_residual)
            taus.append(out.tau)
            self._keep(out)
            if t1 - t_start >= seconds:
                break
        window_s = t1 - t_start
        steps = len(step_ms)
        while len(self.kept) < self.period:     # finish the checked pass
            self._keep(self.step())
        kkt = torch.stack(kkts)
        failed = int(((kkt > self.flag_threshold) | ~torch.isfinite(kkt)
                      | ~torch.isfinite(torch.stack(taus)).all(-1)).sum())
        if segment is not None:
            with spy.active():
                segment.start()
                for _ in range(TRACED_STEPS):
                    self.step()
                segment.stop()
        return dict(window_s=window_s, control_steps=steps, scenario_steps=steps * self.B,
                    failed=failed, step_ms=step_ms,
                    traced_steps=TRACED_STEPS if segment is not None else None)

    def release(self):
        """Drop the program's state before the reference runs."""
        self.inputs = self.carry = self.cache = self.model = None

    def check(self) -> dict:
        """The reference's comparison over the checked pass (float64).  Per
        answer: the relative KKT residual of its (x, y) on the QP the
        reference builds from the same inputs, and the gap between its
        torques and the reference's torque map of its x over max(1, |that
        map|).  `residual_max` is the worst of both over every answer of the
        pass; the others are printed beside it."""
        dev = self.device
        f64 = dict(dtype=torch.float64, device=dev)
        model = ref_anymal.anymal_d_model(torch.float64, dev)
        gains = self.config["controller"]
        first = self.checked_pass * self.period
        carry = ref_wbc.init_carry(self.B, **f64)
        acc = Worst()
        for g in range(max(0, first - REF_LEAD), first + self.period):
            obs, ref, new = self.traffic.step(g % self.period)
            obs = ref_wbc.RobotObservation(**generate.to_torch(obs, torch.float64, dev))
            ref = ref_wbc.Reference(**generate.to_torch(ref, torch.float64, dev))
            new = torch.as_tensor(np.asarray(new, bool), device=dev).expand(self.B)
            qp, tmap, carry = ref_wbc.setup(model, gains, obs, ref, carry, new)
            if g >= first:
                acc.answers(qp, tmap, *self.kept[g], self.flag_threshold)
        return acc.numbers()


class Worst:
    """The worst readings of the answers judged so far."""

    def __init__(self):
        self.kkt = self.kkt_unflagged = self.tau = self.tau_finite = 0.0
        self.flagged = self.count = 0

    def answers(self, qp, tmap, x, y, tau, kkt_reported, threshold):
        x, y = x.double(), y.double()
        kkt = ref_wbc.kkt_residual(qp, x, y)
        want = ref_wbc.torques(tmap, x)
        gap = (tau.double() - want).abs().amax(-1) / torch.clamp_min(
            want.abs().amax(-1), 1.0)
        flagged = ~(kkt_reported <= threshold)
        self.kkt = max(self.kkt, _worst(kkt))
        self.kkt_unflagged = max(self.kkt_unflagged,
                                 _worst(torch.where(flagged, torch.zeros_like(kkt), kkt)))
        self.tau = max(self.tau, _worst(gap))
        finite = torch.isfinite(x).all(-1) & torch.isfinite(tau).all(-1)
        self.tau_finite = max(self.tau_finite, _worst(torch.where(finite, gap, 0.0)))
        self.flagged += int(flagged.sum())
        self.count += kkt.numel()

    def numbers(self) -> dict:
        return {"residual_max": max(self.kkt, self.tau), "kkt_max": self.kkt,
                "kkt_unflagged_max": self.kkt_unflagged, "tau_rel_max": self.tau,
                "tau_rel_finite_max": self.tau_finite,
                "flagged_share": self.flagged / max(self.count, 1)}


def _worst(v) -> float:
    """The largest entry, with a non-finite entry read as infinite."""
    v = torch.where(torch.isfinite(v), v, torch.full_like(v, float("inf")))
    return float(v.max())


class Control(Cell):
    """The control of the comparison: the reference put in the program's
    place (its setup, the frozen single-sample solver `reference/qp.solve`
    warm-started from its own last iterate, its torque map), in float32
    with the matmul precision the caller sets, over the checked pass.  It
    starts REF_LEAD steps before that pass from a cold carry."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from benchmark.reference import qp as ref_qp

        self.config, self.device, self.seed = config, device, seed
        self.B = config["batch"]
        self.dtype = torch.float32
        self.traffic = generate.make(traffic, self.B, seed)
        self.period = self.traffic.period
        self.checked_pass = 1 + int(generate.rng_for(seed, "check").integers(CHECK_PASSES))
        self.kept = {}
        self.ref_qp = ref_qp
        self.params = ref_qp.SolverParams()
        self.flag_threshold = self.params.rescue_threshold
        self.model = ref_anymal.anymal_d_model(self.dtype, device)
        first = self.checked_pass * self.period
        self.steps_done = max(0, first - REF_LEAD)
        self.carry = ref_wbc.init_carry(self.B, self.dtype, device)
        self.warm = ref_qp.QPState(*(torch.zeros((self.B, k), dtype=self.dtype, device=device)
                                     for k in (ref_wbc.N_VARS, ref_wbc.N_ROWS, ref_wbc.N_ROWS)))

    def step(self):
        g = self.steps_done
        obs, ref, new = self.traffic.step(g % self.period)
        obs = ref_wbc.RobotObservation(**generate.to_torch(obs, self.dtype, self.device))
        ref = ref_wbc.Reference(**generate.to_torch(ref, self.dtype, self.device))
        new = torch.as_tensor(np.asarray(new, bool), device=self.device).expand(self.B)
        qp, tmap, self.carry = ref_wbc.setup(self.model, self.config["controller"], obs, ref,
                                             self.carry, new)
        sw = self.carry.switch_flag[:, None]
        warm = self.ref_qp.QPState(x=self.warm.x,
                                   z=torch.where(sw, torch.zeros_like(self.warm.z), self.warm.z),
                                   y=torch.where(sw, torch.zeros_like(self.warm.y), self.warm.y))
        self.warm, info = self.ref_qp.solve(self.ref_qp.QPData(*qp), warm, self.params)
        self.steps_done += 1
        return dict(x=self.warm.x, y=self.warm.y, tau=ref_wbc.torques(tmap, self.warm.x),
                    kkt=info.kkt_residual)

    def run_checked_pass(self):
        while len(self.kept) < self.period:
            out = self.step()
            if (self.steps_done - 1) // self.period == self.checked_pass:
                self.kept[self.steps_done - 1] = (out["x"], out["y"], out["tau"], out["kkt"])

    def release(self):
        self.model = self.carry = self.warm = None


def _hashable(block: dict) -> dict:
    """A configuration block with its lists as tuples (the port's parameter
    objects are frozen dataclasses, used as cache keys)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in block.items()}
