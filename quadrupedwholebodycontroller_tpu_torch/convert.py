"""State carried across frameworks: numpy in, the port's types out.

A caller that holds state as numpy arrays (a checkpoint, a recorded
trajectory, the leaves of another framework's pytrees passed through
`np.asarray`) builds the port's tuples here, so both sides compute on
identical state, including a mid-replay WBCCarry and a warm QPCache, and
the closed loop's planner, simulator and rollout state.
Everything is batch-major; a cache kept batch-minor elsewhere is
transposed by its owner before it gets here.
"""
from __future__ import annotations

import numpy as np
import torch

from quadrupedwholebodycontroller_tpu_torch.control.wbc import (
    Reference,
    RobotObservation,
    WBCCarry,
)
from quadrupedwholebodycontroller_tpu_torch.models.robot_model import (
    _TENSOR_FIELDS,
    PER_SCENARIO_FIELDS,
    RobotModel,
)
from quadrupedwholebodycontroller_tpu_torch.ops.qp import QPCache, QPData, QPState

_STATIC_FIELDS = ("name", "joint_names", "frame_names", "parent", "frame_body")


def _t(a, dtype, device):
    # np.array copies: the source may be a read-only view (a broadcast, the
    # buffer of another framework's array); order="C" because the copy of a
    # broadcast otherwise keeps its batch axis innermost, and the kernels take
    # contiguous batch-major tensors only
    return torch.as_tensor(np.array(a, order="C"), device=device).to(dtype)


def _b(a, device):
    return torch.as_tensor(np.array(a, order="C"), device=device).to(torch.bool)


def model_from_numpy(d: dict, dtype=torch.float32, device="cuda") -> RobotModel:
    """d: the static topology tuples plus every numeric leaf as an array.
    Batched leaves (a leading scenario axis, as a vectorised map over
    `apply_payload` gives every leaf) make one model per scenario: mass,
    com and inertia keep the axis; every other leaf must be the same in
    every scenario and is taken once (a ValueError otherwise)."""
    leaves = {}
    for k, rank in _TENSOR_FIELDS.items():
        a = np.asarray(d[k])
        if a.ndim == rank + 1 and k not in PER_SCENARIO_FIELDS:
            if not (a == a[:1]).all():
                raise ValueError(f"model leaf {k!r} differs between scenarios: only "
                                 f"{', '.join(PER_SCENARIO_FIELDS)} may")
            a = a[0]
        leaves[k] = _t(a, dtype, device)
    return RobotModel(
        **{k: (d[k] if isinstance(d[k], str) else tuple(d[k])) for k in _STATIC_FIELDS},
        **leaves,
    )


def obs_from_numpy(d: dict, dtype=torch.float32, device="cuda") -> RobotObservation:
    return RobotObservation(**{k: _t(d[k], dtype, device) for k in RobotObservation._fields})


def ref_from_numpy(d: dict, dtype=torch.float32, device="cuda") -> Reference:
    return Reference(**{k: _t(d[k], dtype, device) for k in Reference._fields})


def carry_from_numpy(d: dict, dtype=torch.float32, device="cuda") -> WBCCarry:
    """d: WBCCarry's fields, with qp_warm a dict (or tuple) of x, z, y."""
    return WBCCarry(
        **{k: _t(d[k], dtype, device)
           for k in ("old_T", "old_J_st", "old_J_sw", "tdot_inv",
                     "integral_error", "prev_contacts")},
        switch_flag=_b(d["switch_flag"], device),
        deriv_valid=_b(d["deriv_valid"], device),
        qp_warm=qpstate_from_numpy(d["qp_warm"], dtype, device),
    )


def qpdata_from_numpy(d, dtype=torch.float32, device="cuda") -> QPData:
    """d: a dict (or tuple) of H (B, n, n), g (B, n), A (B, m, n), l, u (B, m)."""
    d = d if isinstance(d, dict) else dict(zip(QPData._fields, d))
    return QPData(**{k: _t(d[k], dtype, device) for k in QPData._fields})


def qpstate_from_numpy(d, dtype=torch.float32, device="cuda") -> QPState:
    """d: a dict (or tuple) of x (B, n), z, y (B, m)."""
    d = d if isinstance(d, dict) else dict(zip(QPState._fields, d))
    return QPState(**{k: _t(d[k], dtype, device) for k in QPState._fields})


def cache_from_numpy(d: dict, dtype=torch.float32, device="cuda") -> QPCache:
    """d: kinv (B, n, n), hinv (B, n, n), sinv (B, m, m), batch-major."""
    return QPCache(**{k: _t(d[k], dtype, device).contiguous() for k in QPCache._fields})


def _as_dict(d):
    """A dict, or the fields of a NamedTuple (e.g. another framework's state
    with its leaves turned into numpy arrays)."""
    return d._asdict() if hasattr(d, "_asdict") else d


def _i32(a, device):
    return torch.as_tensor(np.array(a, order="C"), device=device).to(torch.int32)


def planner_state_from_numpy(d, dtype=torch.float32, device="cuda"):
    """The static walk's PlannerState (batched); `ref` a dict or NamedTuple."""
    from quadrupedwholebodycontroller_tpu_torch.planner.gait import PlannerState

    d = _as_dict(d)
    ints = ("mode", "phase", "step_ticks", "cycle_ticks", "cycle_counter")
    return PlannerState(
        **{k: _i32(d[k], device) for k in ints},
        **{k: _t(d[k], dtype, device) for k in PlannerState._fields
           if k not in ints and k != "ref"},
        ref=ref_from_numpy(_as_dict(d["ref"]), dtype, device))


def trot_state_from_numpy(d, dtype=torch.float32, device="cuda"):
    """The trot's TrotState (batched); `ref` a dict or NamedTuple."""
    from quadrupedwholebodycontroller_tpu_torch.planner.trot import TrotState

    d = _as_dict(d)
    ints = ("tick", "phase", "phase_tick")
    return TrotState(
        **{k: _i32(d[k], device) for k in ints},
        **{k: _t(d[k], dtype, device) for k in TrotState._fields
           if k not in ints and k != "ref"},
        ref=ref_from_numpy(_as_dict(d["ref"]), dtype, device))


def sim_state_from_numpy(d, dtype=torch.float32, device="cuda"):
    from quadrupedwholebodycontroller_tpu_torch.sim.world import SimState

    d = _as_dict(d)
    return SimState(**{k: _t(d[k], dtype, device) for k in SimState._fields})


def rollout_carry_from_numpy(d, dtype=torch.float32, device="cuda"):
    """d: `sim`, `wbc` (WBCCarry's fields, `qp_warm` included), `planner`
    (the static walk's or the trot's state, told apart by its fields) and
    `ref`, each a dict or NamedTuple."""
    from quadrupedwholebodycontroller_tpu_torch.sim.rollout import RolloutCarry

    d = _as_dict(d)
    w = dict(_as_dict(d["wbc"]))
    w["qp_warm"] = _as_dict(w["qp_warm"])
    planner = _as_dict(d["planner"])
    to_planner = planner_state_from_numpy if "mode" in planner else trot_state_from_numpy
    return RolloutCarry(sim=sim_state_from_numpy(d["sim"], dtype, device),
                        wbc=carry_from_numpy(w, dtype, device),
                        planner=to_planner(planner, dtype, device),
                        ref=ref_from_numpy(_as_dict(d["ref"]), dtype, device))


def scenario_from_numpy(d, dtype=torch.float32, device="cuda"):
    from quadrupedwholebodycontroller_tpu_torch.sim.scenario import Scenario

    d = _as_dict(d)
    return Scenario(**{k: _t(d[k], dtype, device) for k in Scenario._fields})


def to_numpy(tree):
    """Tensors of a (nested) tuple / dict / NamedTuple as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
