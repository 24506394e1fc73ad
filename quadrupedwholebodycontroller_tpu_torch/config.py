"""Typed configuration objects of the port.

Field names and defaults are those of the reference YAML schemas
(controller: config/params_controller.yaml, planner: config/params_planner.yaml)
and of the JAX package's `config.py`, so one dict of overrides builds both
sides in a test.  The port keeps its own copy: it imports nothing of the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

GRAVITY = 9.81
# "infinity" for one-sided QP bounds: finite, the qpOASES INFTY convention.
# Never `inf`: the kernels test finiteness as |x| < 1e19.
QP_INF = 1.0e20

NUM_JOINTS = 12
NUM_LEGS = 4
NV = 6 + NUM_JOINTS  # floating-base velocity dimension (18)
# QP decision vector: [com accel (6); joint accel (12); GRFs (12); slacks (12)]
QP_NUM_VARS = 6 + NUM_JOINTS + 3 * NUM_LEGS + 3 * NUM_LEGS  # 42
# QP rows: dynamics (6) + stance feet (12) + friction (16) + torque limits
# (12) + swing tracking (24)
QP_NUM_CONSTRAINTS = 6 + 3 * NUM_LEGS + 4 * NUM_LEGS + NUM_JOINTS + 6 * NUM_LEGS  # 70

# Leg order used everywhere (jacobian stacking, contact flags, reference)
LEG_NAMES = ("LH", "LF", "RF", "RH")


@dataclasses.dataclass(frozen=True)
class ControllerParams:
    """WBC gains/limits (reference config/params_controller.yaml)."""

    friction: float = 1.0
    loop_rate: float = 400.0
    max_torque: float = 80.0
    kp: float = 6000.0
    kp_z: float = 10000.0
    kd: float = 1800.0
    ki: float = 0.0
    kp_swing: float = 250.0
    kd_swing: float = 20.0
    slack_weight: float = 1000.0
    initial_reference_pose: Sequence[float] = (0.0, 0.0, 0.50, 0.0, 0.0, 0.0)
    # analytic Tdot/Jdot along the state flow instead of the reference's
    # finite differences (no one-cycle lag, no contact-switch transients)
    exact_derivatives: bool = False
    # with exact_derivatives on the kernel setup path: False = the tangents
    # run inside the setup kernel (K3x); True = the finite-difference kernel
    # plus the forward-mode-AD patch (control/wbc._exact_epilogue_batched),
    # kept as the independent oracle
    exact_epilogue: bool = False

    @property
    def dt(self) -> float:
        return 1.0 / self.loop_rate


@dataclasses.dataclass(frozen=True)
class PlannerParams:
    """Static-walk gait parameters (reference config/params_planner.yaml)."""

    step_length: float = 0.1
    height_control_point: float = 0.1
    x_offset: float = 0.50
    y_offset: float = 0.33
    step_duration: float = 0.2
    body_height: float = 0.50
    body_final_velocity: float = 0.40
    dt: float = 0.01

    @property
    def cycle_duration(self) -> float:
        return 4.0 * self.step_duration


@dataclasses.dataclass(frozen=True)
class QPSolverParams:
    """Batched OSQP-style ADMM + active-set polish settings.

    The defaults are the shipped configuration of the main path.  Every
    field runs on the port; the ones marked "accepted" or "kept for parity"
    compute the same result at any value (the JAX package reads them for
    TPU layouts, matmul modes or buffer routing)."""

    iterations: int = 40          # ADMM iterations per hot-started solve
    cold_iterations: int = 200    # budget when some warm start is all-zero
    rho: float = 0.5              # base ADMM penalty
    rho_eq_scale: float = 1000.0  # penalty boost on equality rows
    sigma: float = 0.0            # 0 = constraint-space (z, y) ADMM kernel
    alpha: float = 1.6            # over-relaxation
    scaling_iters: int = 4        # Ruiz equilibration sweeps
    ns_iters: int = 30            # cold Newton-Schulz iterations
    ns_warm_iters: int = 2        # NS iterations restarting from the cache
    ns_warm_iters_polish: int = 0  # same for the polish Schur inverse; 0 =
                                  # the carried inverse is used as it is
    polish: bool = True
    polish_rounds: int = 2        # round 2 is the active-set DROP round
    polish_reg: float = 1e-9
    polish_refine: int = 5        # coupled refinement passes per round
    rescue_threshold: float = 3e-3  # relative KKT above which the staged
                                  # tail rescue fires; <= 0 disables
    rescue_iterations: int = 40
    rescue_polish_rounds: int = 2
    rescue_batch: int = 128       # rescue the top-k worst scenarios only
    rescue_stages: int = 3
    rescue_comp_refine: int = 2   # compensated (double-f32) passes
    comp_final_refine: int = 0    # compensated passes on the final iterate
                                  # before the rescue (both backends)
    cold_batch: int = 512         # per-scenario warm gate: scenarios whose
                                  # contacts switched are re-inverted cold
                                  # on a compacted top-k sub-batch
    drop_batch: int = 64          # cap of the compacted polish drop round
    drop_fire_tol: float = 0.0    # drop round: fire only above this
                                  # max(res, sign violation); 0 = any failure
    drop_warm_iters: int = 0      # warm the compacted drop round's Schur
                                  # inverse from the carried rows (0: cold)
    drop_sinv_refresh: int = 0    # 1: carry the drop round's fresh Schur
                                  # inverses into the cache
    drop_ns_iters: int = 0        # the drop round's cold budget (0: ns_iters)
    ns_cold_prec: str = "high"    # accepted and ignored: the port runs the
    ns_cold_tail: int = 10        # cold chains at full float32 throughout
    cond_hoist: int = 0           # accepted and not read: it routes lax.cond
                                  # buffers in the JAX package, same values
    drop_approx_rank: int = 0     # accepted: the drop round ranks with the
                                  # exact topk (JAX's approx_max_k on a TPU)
    rescue_round2_batch: int = 32  # cap of the rescue's compacted round 2+
    solve_layout: str = "minor"   # kept for parity and ignored: the port
                                  # is batch-major end to end


# reference YAML key -> ControllerParams field (config/params_controller.yaml)
_YAML_CONTROLLER_KEYS = {
    "friction": "friction",
    "loopRate": "loop_rate",
    "maxTorque": "max_torque",
    "kpValue": "kp",
    "kpValueZ": "kp_z",
    "kdValue": "kd",
    "kiValue": "ki",
    "kpSwingValue": "kp_swing",
    "kdSwingValue": "kd_swing",
    "slackWeight": "slack_weight",
    "initialReferencePose": "initial_reference_pose",
}
# PlannerParams fields under their own names (config/params_planner.yaml)
_YAML_PLANNER_KEYS = ("step_length", "height_control_point", "x_offset", "y_offset",
                      "step_duration", "body_height", "body_final_velocity", "dt")


def load_yaml_params(path: str) -> dict:
    """A reference-format YAML (the params_controller.yaml /
    params_planner.yaml key names) as typed parameters: {"controller":
    ControllerParams} and / or {"planner": PlannerParams}, for the keys the
    file has (defaults for the rest).  Needs PyYAML, imported here only."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    ctrl = {v: raw[k] for k, v in _YAML_CONTROLLER_KEYS.items() if k in raw}
    plan = {k: raw[k] for k in _YAML_PLANNER_KEYS if k in raw}
    out = {}
    if ctrl:
        if "initial_reference_pose" in ctrl:
            ctrl["initial_reference_pose"] = tuple(ctrl["initial_reference_pose"])
        out["controller"] = ControllerParams(**ctrl)
    if plan:
        out["planner"] = PlannerParams(**plan)
    return out
