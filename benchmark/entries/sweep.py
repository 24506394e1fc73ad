"""The robustness-sweep cells (configuration entry "sweep").

The timed path is the port's sweep, `parallel.sweep.sharded_sweep_step`
-> `run(carry, commands, scenario, mark)` on the one-rank mesh
(`make_mesh` without a process group): planner, batched control step,
simulator with one payload model per scenario, freeze masks and the
sweep's metrics.  Each call is one episode of the traffic's E control
steps from the same start carry; the cache starts cold in every call, as
in a new sweep, so a faster program repeats the same mix of work.

Set-up draws the episode from the seed and runs its first `warmup_steps`
steps once.  The window runs whole episodes until `seconds` have passed;
a wrapper around the control step keeps each step's KKT residuals and
torques by reference (for `failed`).  In the first episode the checked
periods are captured too: S consecutive control periods drawn from the
seed, with the REF_LEAD periods before them that the reference's carry
needs, and the freeze rule's inputs of every period up to them, taken by
wrapping the planner, the control step and the simulator period where the
loop calls them.  With `--trace 1` the window's CUDA events at every
stage boundary give the simulator's share, and a further, unwrapped
episode after the window gives the traced segment.
"""
from __future__ import annotations

import contextlib
import importlib
import itertools
import time

import numpy as np
import torch

from benchmark import generate
from benchmark.entries.wbc_step import Worst, _hashable
from benchmark.reference import anymal as ref_anymal
from benchmark.reference import gait as ref_gait
from benchmark.reference import scenario as ref_scenario
from benchmark.reference import trot as ref_trot
from benchmark.reference import wbc as ref_wbc
from benchmark.reference import world as ref_world

PORT = "quadrupedwholebodycontroller_tpu_torch"
REF_LEAD = 40       # periods before the checked ones that rebuild the carry
CHECKED = 8         # consecutive checked periods
TRACE_FROM, TRACE_PERIODS = 80, 2   # the traced periods of a --trace 1 run
Z_OFFSET = 0.05     # the reset pose's base height above the reference pose


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def _rows_finite(tree):
    """(B,) True where every leaf of the tree is finite for that scenario."""
    ok = None
    for t in _leaves(tree):
        if t.is_floating_point():
            f = torch.isfinite(t.reshape(t.shape[0], -1)).all(-1)
            ok = f if ok is None else ok & f
    return ok


def _row_gaps(got, want, rows=None):
    """Per scenario, the largest |got - want| over max(1, |want|) of each
    leaf (the scale taken over the whole leaf), over two trees of tensors
    with a leading scenario axis, on the scenarios `rows` (all by default).
    A non-finite entry reads as infinite."""
    worst = None
    for g, w in zip(_leaves(got), _leaves(want)):
        if rows is not None:
            g, w = g[rows], w[rows]
        if not g.is_floating_point():
            differs = (g.to(w.dtype) != w).reshape(g.shape[0], -1).any(-1)
            d = torch.where(differs, float("inf"), 0.0).double()
        else:
            g, w = g.double(), w.double()
            scale = torch.clamp_min(w.abs().amax(), 1.0) if w.numel() else 1.0
            d = ((g - w).abs() / scale).reshape(g.shape[0], -1)
            d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf"))).amax(-1)
        worst = d if worst is None else torch.maximum(worst, d)
    return worst


def _gap(got, want, rows=None) -> float:
    d = _row_gaps(got, want, rows)
    return float(d.max()) if d is not None and d.numel() else 0.0


class _Cut(Exception):
    """Ends an episode once the window has closed."""


class Capture:
    """What the check reads of the first episode, by period index.  Only the
    solver's answers are copied (the solver's buffers may be reused); the
    rest are references to the tensors the loop made, so the capture adds
    no device work but those copies in the REF_LEAD + CHECKED periods."""

    def __init__(self, first: int, periods: int):
        self.first, self.last = first, first + periods
        self.k = -1
        self.control = {}    # k -> (obs, ref, ref_is_new, x, y, tau, kkt), lead periods
        self.planner = {}    # k -> (state, cmd, (new_state, ref, published)), ticks to last
        self.sim = {}        # k -> (state, tau, friction, push, new), checked periods and 0
        # the freeze rule's inputs and the loop's decision, periods 0 .. last - 1:
        # the control step's CoM, the simulator's new velocity and base
        # position, and the velocity each period starts from
        self.com, self.u_out, self.p_out, self.u_in = {}, {}, {}, {}

    def lead(self, k):
        return self.first - REF_LEAD <= k < self.last

    def checked(self, k):
        return self.first <= k < self.last


def freeze_check(cap: Capture):
    """The loop's freeze decisions against its rule (sim/rollout: a scenario
    stays live while its state is finite, its speed under 50 and its CoM
    height in (0.2, 2.0) m), on the program's own numbers.  The loop
    carried a scenario into period k+1 where that period starts from the
    simulator's output of period k.  Returns (the scenario-periods where
    the two differ, {checked period: scenarios not carried into it})."""
    rule, mismatches, frozen_at = None, 0, {}
    for k in range(cap.last - 1):
        if k + 1 not in cap.u_in:
            break
        u, p, z = cap.u_out[k], cap.p_out[k], cap.com[k][:, 2]
        sane = (torch.isfinite(u).all(-1) & torch.isfinite(p).all(-1) & (z > 0.2) & (z < 2.0)
                & (u.abs().amax(-1) < 50.0))
        rule = sane if rule is None else rule & sane
        carried = (cap.u_in[k + 1] == u).all(-1)
        mismatches += int((carried != rule).sum())
        if cap.checked(k + 1):
            frozen_at[k + 1] = ~carried
    return mismatches, frozen_at


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from quadrupedwholebodycontroller_tpu_torch.config import (
            ControllerParams, PlannerParams, QPSolverParams)
        from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
        from quadrupedwholebodycontroller_tpu_torch.parallel import make_mesh, sharded_sweep_step
        from quadrupedwholebodycontroller_tpu_torch.planner import trot
        from quadrupedwholebodycontroller_tpu_torch.sim import SimParams
        from quadrupedwholebodycontroller_tpu_torch.sim.rollout import init_rollout_carry
        from quadrupedwholebodycontroller_tpu_torch.sim.scenario import Scenario

        self.config, self.device, self.seed = config, device, seed
        self.B = config["batch"]
        self.dtype = getattr(torch, config["dtype"])
        self.ep = generate.make(traffic, self.B, seed)
        self.E = self.ep.steps
        self.flag_threshold = QPSolverParams(**config["qp_solver"]).rescue_threshold
        model = anymal_d_model(self.dtype, device)
        cp = ControllerParams(**_hashable(config["controller"]))
        pp = PlannerParams(**config["planner"])
        qpp = QPSolverParams(**config["qp_solver"])
        sp = SimParams(**config["sim"])
        kw = dict(dtype=self.dtype, device=device)
        self.commands = torch.as_tensor(self.ep.commands, **kw)
        self.scenario = Scenario(sim_friction=torch.as_tensor(self.ep.friction, **kw),
                                 payload_mass=torch.as_tensor(self.ep.payload_mass, **kw),
                                 payload_com=torch.as_tensor(self.ep.payload_com, **kw),
                                 push_wrench=torch.as_tensor(self.ep.push, **kw))
        planner_state = (trot.init_trot_state(trot.TrotParams(), self.B, **kw)
                         if self.ep.gait == "trot" else None)
        self.start = init_rollout_carry(model, cp, self.B, pp, self.dtype, device,
                                        planner_state=planner_state)
        self.run = sharded_sweep_step(model, cp, pp, qpp, sp, make_mesh(device=device),
                                      self.ep.gait)
        self.first = REF_LEAD + int(generate.rng_for(seed, "check").integers(
            self.E - REF_LEAD - CHECKED + 1))
        self.capture = None
        W = config["warmup_steps"]
        self.run(self.start, self.commands[:, :W],
                 self.scenario._replace(push_wrench=self.scenario.push_wrench[:, :W]))

    # -- wrappers around the loop's callees --------------------------------
    @contextlib.contextmanager
    def _wrapped(self, outs: list, cap: Capture | None, clock: dict):
        """Every control step's (kkt, tau) inside the window is kept by
        reference in `outs`; with `cap` (the first episode) the checked
        periods' inputs and outputs are captured too."""
        wbc = importlib.import_module(PORT + ".control.wbc")
        world = importlib.import_module(PORT + ".sim.world")
        planner = importlib.import_module(PORT + ".planner." + (
            "trot" if self.ep.gait == "trot" else "gait"))
        p_name = "trot_step" if self.ep.gait == "trot" else "planner_step"
        step_fn, sim_fn, plan_fn = wbc.wbc_step_batched, world.sim_control_period, \
            getattr(planner, p_name)

        def step(model, cp, qpp, obs, ref, carry, ref_is_new, *a, **kw):
            out = step_fn(model, cp, qpp, obs, ref, carry, ref_is_new, *a, **kw)
            if clock["closed"] is None:
                outs.append((out[0].qp_info.kkt_residual, out[0].tau))
            if cap is not None and cap.k < cap.last:
                cap.com[cap.k] = out[0].com_pos
                if cap.lead(cap.k):
                    cap.control[cap.k] = (obs, ref, ref_is_new) + _clone((
                        out[0].qp_x, out[1].qp_warm.y, out[0].tau, out[0].qp_info.kkt_residual))
            return out

        def sim(model, state, tau, params, friction=None, push=None):
            new = sim_fn(model, state, tau, params, friction, push)
            k = cap.k
            if k < cap.last:
                cap.u_in[k], cap.u_out[k], cap.p_out[k] = state.u, new.u, new.base_p
            if cap.checked(k) or k == 0:
                cap.sim[k] = (state, tau, friction, push, new)
            return new

        def plan(params, state, cmd):
            out = plan_fn(params, state, cmd)
            if cap.k < cap.last:
                cap.planner[cap.k] = (state, cmd, out)
            return out

        wbc.wbc_step_batched = step
        if cap is not None:
            world.sim_control_period = sim
            setattr(planner, p_name, plan)
        try:
            yield
        finally:
            wbc.wbc_step_batched, world.sim_control_period = step_fn, sim_fn
            setattr(planner, p_name, plan_fn)

    def window(self, seconds: float, sync, segment=None, spy=None):
        """Episodes until `seconds` have passed: the window closes at the end
        of the control period in which the time runs out, and that episode
        is cut at its next period (once the checked periods are in).  With a
        trace `segment`, CUDA events at every stage boundary of the window
        give the simulator's share, and once the window has closed a further
        episode runs to its period TRACE_FROM and traces TRACE_PERIODS
        periods with the launch records of `spy`."""
        outs, timed = [], []
        clock = {"closed": None}
        periods = 0
        timing = segment is not None and self.device != "cpu"
        t_start = time.perf_counter()
        for episode in itertools.count():
            cap = Capture(self.first, CHECKED) if episode == 0 else None
            events, done = {}, []

            def mark(k, stage, cap=cap, events=events, done=done):
                if stage == "planner":
                    if clock["closed"] is not None and (cap is None or k >= cap.last):
                        raise _Cut
                    if cap is not None:
                        cap.k = k
                if timing and clock["closed"] is None:
                    e = events[(k, stage)] = torch.cuda.Event(enable_timing=True)
                    e.record()
                if stage == "end" and clock["closed"] is None:
                    done.append(k)
                    if time.perf_counter() - t_start >= seconds:
                        sync()
                        clock["closed"] = time.perf_counter() - t_start

            try:
                with self._wrapped(outs, cap, clock):
                    self.run(self.start, self.commands, self.scenario, mark)
            except _Cut:
                pass
            periods += len(done)
            timed.append((events, done))
            if episode == 0:
                self.capture = cap
            if clock["closed"] is not None:
                break
        sync()
        kkt = torch.stack([o[0] for o in outs])
        tau = torch.stack([o[1] for o in outs])
        failed = int(((kkt > self.flag_threshold) | ~torch.isfinite(kkt)
                      | ~torch.isfinite(tau).all(-1)).sum())
        spans = None
        if timing:
            spans = {"sim_ms": sum(ev[(k, "sim")].elapsed_time(ev[(k, "end")])
                                   for ev, done in timed for k in done),
                     "period_ms": sum(ev[(k, "planner")].elapsed_time(ev[(k, "end")])
                                      for ev, done in timed for k in done)}
        if segment is not None:
            self._traced_episode(segment, spy)
        return dict(window_s=clock["closed"], control_steps=periods,
                    scenario_steps=periods * self.B, failed=failed, spans=spans,
                    traced_steps=TRACE_PERIODS if segment is not None else None)

    def _traced_episode(self, segment, spy):
        first = min(TRACE_FROM, self.E - TRACE_PERIODS)
        active = spy.active()

        def mark(k, stage):
            if stage != "planner":
                return
            if k == first:
                segment.start()
                active.__enter__()
            elif k == first + TRACE_PERIODS:
                active.__exit__(None, None, None)
                segment.stop()
                raise _Cut
        try:
            self.run(self.start, self.commands, self.scenario, mark)
        except _Cut:
            pass
        if segment.window_s is None:     # the episode ended inside the segment
            active.__exit__(None, None, None)
            segment.stop()

    def release(self):
        self.run = self.start = self.commands = self.scenario = None

    # -- the reference's comparison ------------------------------------------
    def check(self) -> dict:
        """On the program's own states, period by period (float64): the
        planner's output for its input state and command, the control
        step's answers (the relative KKT residual of (x, y) on the QP the
        reference builds, the torque map's gap; the carry rebuilt from the
        REF_LEAD periods before), and the simulator's state after each
        period for its state, torques, payload, friction and push; the
        loop's freeze decisions against its rule (`freeze_check`); and the
        start state against the reference's reset pose.  A scenario the loop
        froze before a checked period is left out of that period's answers."""
        cap, dev = self.capture, self.device
        mismatches, frozen_at = freeze_check(cap)
        f64 = dict(dtype=torch.float64, device=dev)
        model = ref_anymal.anymal_d_model(torch.float64, dev)
        gains, sim_params = self.config["controller"], ref_world.SimParams(**self.config["sim"])
        as64 = lambda a: torch.as_tensor(np.asarray(a, np.float32), **f64)
        sim_model = ref_scenario.apply_payload(model, as64(self.ep.payload_mass),
                                               as64(self.ep.payload_com))
        planner_gap = 0.0
        acc = Worst()
        carry = ref_wbc.init_carry(self.B, **f64)
        for k in range(self.first - REF_LEAD, self.first + CHECKED):
            obs, ref, new, x, y, tau, kkt = cap.control[k]
            qp, tmap, carry = ref_wbc.setup(
                model, gains, ref_wbc.RobotObservation(*(t.double() for t in obs)),
                ref_wbc.Reference(*(t.double() for t in ref)), carry,
                torch.as_tensor(new, device=dev).expand(self.B))
            if k >= self.first:
                live = ~frozen_at[k]
                acc.answers(type(qp)(*(t[live] for t in qp)), type(tmap)(*(t[live] for t in tmap)),
                            x[live], y[live], tau[live], kkt[live], self.flag_threshold)
        # a scenario whose input is not finite (the program froze it) says
        # nothing about the planner or the simulator
        for k, (state, cmd, (new_state, pref, published)) in cap.planner.items():
            want = self._ref_planner(state, cmd)
            planner_gap = max(planner_gap, _gap((new_state, pref, published), want,
                                                _rows_finite((state, cmd))))
        rows = []
        for k, (state, tau, friction, push, new) in cap.sim.items():
            if k < self.first:
                continue
            want = ref_world.sim_control_period(
                sim_model, ref_world.SimState(*(t.double() for t in state)), tau.double(),
                sim_params, friction.double(), push.double())
            rows.append(_row_gaps(new, want, _rows_finite((state, tau))))
        rows = torch.cat(rows)
        sim_q99 = float(torch.quantile(rows, 0.99)) if rows.numel() else 0.0
        start_sim = ref_world.init_sim_state(model, *_reset_pose(self.config, self.B, f64))
        n = acc.numbers()
        return {**n, "sim_gap_q99": sim_q99, "freeze_mismatch": float(mismatches),
                "frozen_share": float(torch.stack(list(frozen_at.values())).double().mean()), "sim_gap": float(rows.max()) if rows.numel() else 0.0,
                "planner_gap": planner_gap,
                "start_gap": _gap(cap.sim[0][0], start_sim)}

    def _ref_planner(self, state, cmd):
        state = _as64(state)
        if self.ep.gait == "trot":
            return ref_trot.trot_step(ref_trot.TrotParams(), state, cmd.double())
        return ref_gait.planner_step(ref_gait.PlannerParams(**self.config["planner"]), state,
                                     cmd.double())


def _reset_pose(config, B, kw):
    """The reset pose of the sweep's start (the port's `init_rollout_carry`):
    the reference pose's base height + Z_OFFSET, the initial joint angles."""
    pose = config["controller"]["initial_reference_pose"]
    base_p = torch.tensor([pose[0], pose[1], pose[2] + Z_OFFSET], **kw).expand(B, 3)
    q = torch.tensor(ref_anymal.INITIAL_JOINT_POS, **kw).expand(B, 12)
    return base_p.contiguous(), q.contiguous()


def _as64(tree):
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_as64(v) for v in tree))
    return tree


class Control(Cell):
    """The control of the comparison: the reference put in the program's
    place for the whole closed loop (its planner, its control step with
    the frozen single-sample solver warm-started from its own last iterate,
    its simulator with the payload models, the loop's freeze rule on the
    base height in place of the CoM's), in
    float32 with the matmul precision the caller sets, from the episode's
    start through the checked periods, captured as the program's are."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from benchmark.reference import qp as ref_qp

        self.config, self.device, self.seed = config, device, seed
        self.B = config["batch"]
        self.ep = generate.make(traffic, self.B, seed)
        self.E = self.ep.steps
        self.first = REF_LEAD + int(generate.rng_for(seed, "check").integers(
            self.E - REF_LEAD - CHECKED + 1))
        self.flag_threshold = ref_qp.SolverParams().rescue_threshold
        self.ref_qp = ref_qp

    def run_checked_pass(self):
        B, dev, qpm = self.B, self.device, self.ref_qp
        kw = dict(dtype=torch.float32, device=dev)
        as32 = lambda a: torch.as_tensor(np.asarray(a), **kw)
        model = ref_anymal.anymal_d_model(torch.float32, dev)
        sim_model = ref_scenario.apply_payload(model, as32(self.ep.payload_mass),
                                               as32(self.ep.payload_com))
        friction, push, commands = as32(self.ep.friction), as32(self.ep.push), \
            as32(self.ep.commands)
        gains, sp = self.config["controller"], ref_world.SimParams(**self.config["sim"])
        if self.ep.gait == "trot":
            tp = ref_trot.TrotParams()
            pstate = ref_trot.init_trot_state(tp, B, **kw)
            planner = lambda s, c: ref_trot.trot_step(tp, s, c)
            ratio = max(1, int(round(gains["loop_rate"] * tp.dt)))
        else:
            pp = ref_gait.PlannerParams(**self.config["planner"])
            pstate = ref_gait.init_planner_state(pp, B, **kw)
            planner = lambda s, c: ref_gait.planner_step(pp, s, c)
            ratio = int(round(gains["loop_rate"] * pp.dt))
        sim = ref_world.init_sim_state(model, *_reset_pose(self.config, B, kw))
        ref = ref_wbc.Reference.standing(gains["initial_reference_pose"], B, **kw)
        carry = ref_wbc.init_carry(B, **kw)
        warm = qpm.QPState(*(torch.zeros((B, k), **kw)
                             for k in (ref_wbc.N_VARS, ref_wbc.N_ROWS, ref_wbc.N_ROWS)))
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        no_tick = torch.zeros(B, dtype=torch.bool, device=dev)
        cap = self.capture = Capture(self.first, CHECKED)
        params = qpm.SolverParams()
        for k in range(self.first + CHECKED):
            cap.k = k
            cmd = commands[:, k]
            if k % ratio == 0:
                new_p, new_ref, is_new = planner(pstate, cmd)
                cap.planner[k] = (pstate, cmd, (new_p, new_ref, is_new))
                pstate, ref = new_p, ref_gait.tree_where(is_new, new_ref, ref)
            else:
                is_new = no_tick
            obs = ref_world.observe(sim)
            qp, tmap, carry2 = ref_wbc.setup(model, gains, obs, ref, carry, is_new)
            sw = carry2.switch_flag[:, None]
            w0 = qpm.QPState(x=warm.x, z=torch.where(sw, torch.zeros_like(warm.z), warm.z),
                             y=torch.where(sw, torch.zeros_like(warm.y), warm.y))
            st, info = qpm.solve(qpm.QPData(*qp), w0, params)
            tau = ref_wbc.torques(tmap, st.x)
            if cap.lead(k):
                cap.control[k] = _clone((obs, ref, is_new, st.x, st.y, tau, info.kkt_residual))
            new = ref_world.sim_control_period(sim_model, sim, tau, sp, friction, push[:, k])
            if cap.checked(k) or k == 0:
                cap.sim[k] = _clone((sim, tau, friction, push[:, k], new))
            cap.com[k], cap.u_in[k], cap.u_out[k], cap.p_out[k] = obs.base_p, sim.u, new.u, \
                new.base_p
            finite = torch.isfinite(new.u).all(-1) & torch.isfinite(new.base_p).all(-1)
            com_z = obs.base_p[:, 2]
            alive = (alive & finite & (new.u.abs().amax(-1) < 50.0) & (com_z > 0.2)
                     & (com_z < 2.0))
            sim = ref_gait.tree_where(alive, new, sim)
            carry = ref_gait.tree_where(alive, carry2, carry)
            warm = ref_gait.tree_where(alive, st, warm)

    def release(self):
        pass
