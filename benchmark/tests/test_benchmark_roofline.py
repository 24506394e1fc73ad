"""The benchmark's frozen roofline arithmetic gives what `chip_smoke.py`
computes for K1, K2 and K3 at B = 4096 (its `flops_of` and `setup_bytes`,
and the solver kernels' bytes: every tensor argument and output once), and
the launch records count each wrapped call once with its own batch."""
import ast
import os

import numpy as np
import pytest
import torch

from benchmark import generate, roofline as R, run, spy

SMOKE = os.path.join(run.ROOT, "chip_smoke.py")
NAMES = {"N", "M", "KBLK", "K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K3X",
         "SETUP_RESULT", "SETUP_CARRY", "PREP_OUT", "HBM_BYTES_PER_S", "F32_FLOPS"}


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py's constants and its two arithmetic functions, taken
    from its source (importing it needs a card)."""
    if not os.path.exists(SMOKE):
        pytest.skip("chip_smoke.py is not in this tree")
    tree = ast.parse(open(SMOKE).read())
    keep = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in NAMES or
                isinstance(t, ast.Tuple) and any(getattr(e, "id", None) in NAMES for e in t.elts)
                for t in node.targets):
            keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in ("flops_of", "setup_bytes"):
            keep.append(node)
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), SMOKE, "exec"), ns)
    return ns


def test_peaks(smoke):
    assert (R.HBM_BYTES_PER_S, R.F32_FLOPS) == (smoke["HBM_BYTES_PER_S"], smoke["F32_FLOPS"])


@pytest.mark.parametrize("name,kw", [
    (R.K1, {"iters": 40}), (R.K1, {"iters": 160}), (R.K2, {"refine": 5}),
    (R.K3, {"qp_params": None})])
def test_flops_match_the_smoke(smoke, name, kw):
    assert R.flops_of(name, 4096, kw) == smoke["flops_of"](name, 4096, kw)


def test_fused_setup_flops_and_bytes_match_the_smoke(smoke):
    from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
    from quadrupedwholebodycontroller_tpu_torch.control import wbc
    from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup

    B, qpp = 4096, QPSolverParams()
    assert R.flops_of(R.K3, B, {"qp_params": qpp}) == smoke["flops_of"](R.K3, B, {"qp_params": qpp})
    spec = run.load_json(os.path.join(run.HERE, "traffic", "replay_walk.json"))
    obs, ref, new = generate.make(spec, B, 5).step(30)
    obs = wbc.RobotObservation(**generate.to_torch(obs, torch.float32, "cpu"))
    ref = wbc.Reference(**generate.to_torch(ref, torch.float32, "cpu"))
    carry = wbc.init_carry(B, torch.float32, "cpu")
    ref_is_new = torch.full((B,), bool(new[0]))
    args = (anymal_d_model(torch.float32, "cpu"), ControllerParams(), obs, ref, carry, ref_is_new)
    s = spy.LaunchSpy()
    with s.active():
        res = setup.setup_batched(*args, qp_params=qpp)
    cu = res["carry_updates"]
    got = [res[k] for k in smoke["SETUP_RESULT"]] + [cu[k] for k in smoke["SETUP_CARRY"]] \
        + list(res["prepared"])
    assert s.records == [(R.K3, B, R.flops_of(R.K3, B, {"qp_params": qpp}),
                          smoke["setup_bytes"](args, got, exact=False))]


def test_solver_kernel_bytes_are_arguments_and_outputs():
    B, n, m = 4096, R.N, R.M
    t = lambda *s: torch.zeros(s)
    outs = (t(B, n), t(B, m), t(B, m), t(B), t(B), t(B))
    records = []
    args = (t(B, n, n), t(B, m, n)) + tuple(t(B, m) for _ in range(7)) + (t(B, n, n),) \
        + tuple(t(B, m) for _ in range(2)) + (t(B, n), t(B, m))
    spy._admm_zy(lambda *r: records.append(r), lambda *a, **k: outs)(*args, iters=40, alpha=1.6)
    size = sum(x.numel() * 4 for x in args + outs)
    assert records == [(R.K1, B, R.flops_of(R.K1, B, {"iters": 40}), size)]
    H = (t(B, n), t(B, 12, 12), 18)
    rest = (t(B, m, m), t(B, m, n)) + tuple(t(B, m) for _ in range(2)) + (t(B, n),) \
        + tuple(t(B, m) for _ in range(3))
    records.clear()
    spy._polish(lambda *r: records.append(r), lambda *a, **k: outs)(H, H, *rest, refine=5,
                                                                     reg=1e-9)
    size = sum(x.numel() * 4 for x in H[:2] + H[:2] + rest + outs)
    assert records == [(R.K2, B, R.flops_of(R.K2, B, {"refine": 5}), size)]
    assert np.isclose(R.bound_seconds(*records[0][2:]),
                      max(records[0][2] / R.F32_FLOPS, records[0][3] / R.HBM_BYTES_PER_S))
