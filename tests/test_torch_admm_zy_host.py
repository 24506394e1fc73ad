"""The constraint-space ADMM kernel's own source, `csrc/admm_zy.cu`,
compiled as plain C++ (one emulated thread per block, the threads of every
stage in rising and in falling order: `admm_zy.admm_zy_iterations_res_host`)
against `admm_zy.admm_zy_iterations_res_plain`, which
`tests/test_torch_kernels_plain.py` holds to the JAX package's Pallas
kernel.

Cases, each in float64 and float32:
  * "walk": the ADMM inputs of recorded walking step 60 (one leg in swing:
    masked friction rows, equality rows and +-1e20 bounds) as the main path
    hands them to the kernel: the plain ADMM run cold from zero gives the
    warm start, which is scaled again; B = 3 perturbed scenarios, 40
    iterations;
  * "cold200": the same problems from the cold start, 200 iterations (the
    step-0 cold-start budget);
  * "resolving": the cold start, 3 iterations: pr, du and sv are 1e-2..1,
    not at the rounding floor;
  * "synthetic": the WBC-structured QP batch of
    `tests/test_torch_kernels_plain.py` (B = 5, an all-zero row of A),
    scaled by the plain prepare stage;
  * "odd": a random QP batch of odd sizes (B = 2, n = 9, m = 15) inside the
    register instantiation's maxima;
  * "above": a random QP batch above them (B = 2, n = 46, m = 75), which
    takes the shared-memory instantiation (as float64 does at every shape).
Every output is measured in share of its scale, max(1, max |plain|).  In
float64 the host build is held to the plain version within 1e-10 (they sum
in other orders, and the kernel fuses the update's products as the card
does, the plain version does not; measured at most 2e-11).  In float32 both
are the float64 answer plus float32's rounding carried through the
iterations (rho = 500 on equality rows amplifies it in y), so the host
build may be no further from the float64 plain version (on the same
float32-rounded inputs) than 4 times the float32 plain version is, plus
1e-6 (measured at most 2.7 times, on "odd").  The two stage orders must
agree bit for bit: no thread of a stage reads what another thread of the
same stage writes.  Also: the wrapper refuses a shape that neither
instantiation takes.  Needs a C++ compiler."""
import shutil

import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch import replay
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import qp
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import admm_zy, build, prepare
from quadrupedwholebodycontroller_tpu_torch.ops.linalg import ns_inverse
from tests._torch_port_util import load_walk, scaled_err
from tests.test_torch_kernels_plain import _problem

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="needs a C++ compiler to build csrc/admm_zy.cu for the CPU")

B_WALK = 3
TOL64 = 1e-10
GUARD, GUARD_ATOL = 4.0, 1e-6


def _walk_inputs():
    """(cold, warm) ADMM arguments of walking step 60, float64, and the
    solver parameters."""
    dt, dev = torch.float64, "cpu"
    model = anymal_d_model(dt, dev)
    cp, qpp = ControllerParams(), QPSolverParams()
    rng = np.random.default_rng(71)
    obs, ref, _ = replay.step_inputs(load_walk(), 60, B_WALK, dt,
                                     replay.make_offsets(B_WALK, dt, rng, dev), dev)
    carry = wbc.init_carry(B_WALK, dt, dev)
    carry = carry._replace(prev_contacts=ref.contacts.clone())
    d = wbc.wbc_setup(model, cp, obs, ref, carry,
                      torch.ones(B_WALK, dtype=torch.bool)).qp_data
    n, m = d.A.shape[-1], d.A.shape[-2]
    z = qp.QPState.zeros(B_WALK, n, m, dt, dev)
    pk = dict(sweeps=qpp.scaling_iters, rho0=qpp.rho, rho_eq_scale=qpp.rho_eq_scale)
    sH, sA, sg, sl, su, rho, _, _, _, ds, es = prepare.prepare_scaled_plain(
        d.H, d.A, d.g, d.l, d.u, z.x, z.z, z.y, **pk)
    Kinv = ns_inverse(sH + (sA.transpose(-1, -2) * rho[:, None, :]) @ sA, qpp.ns_iters)
    cold = (Kinv, sA, sg, sl, su, rho, z.x, z.z, z.y, sH, d.l, d.u, ds, es)
    x, zz, y, *_ = admm_zy.admm_zy_iterations_res_plain(
        *cold, iters=qpp.cold_iterations, alpha=qpp.alpha)
    p = prepare.prepare_scaled_plain(d.H, d.A, d.g, d.l, d.u, ds * x, zz / es, es * y, **pk)
    warm = (Kinv, *p[1:9], p[0], d.l, d.u, p[9], p[10])
    return cold, warm, qpp


def _scaled_case(H, A, g, l, u, x0, z0, y0):
    """Kernel arguments of a QP batch scaled by the plain prepare stage, with
    K^-1 by a dense inverse."""
    sH, sA, sg, sl, su, rho, wx, wz, wy, ds, es = prepare.prepare_scaled_plain(
        H, A, g, l, u, x0, z0, y0, sweeps=4, rho0=0.5, rho_eq_scale=1000.0)
    Kinv = torch.linalg.inv(sH + (sA.transpose(-1, -2) * rho[:, None, :]) @ sA)
    return (Kinv, sA, sg, sl, su, rho, wx, wz, wy, sH, l, u, ds, es)


def _random_case(B, n, m, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    H = G @ np.swapaxes(G, 1, 2) / n + np.eye(n)
    A = rng.standard_normal((B, m, n))
    A[:, 1] = 0.0
    l, u = -rng.uniform(0.1, 1.0, (B, m)), rng.uniform(0.1, 1.0, (B, m))
    l[:, 0] = u[:, 0] = 0.3          # an equality row
    u[:, 3], l[:, 4] = 1e20, -1e20    # one-sided rows
    t = torch.as_tensor
    return _scaled_case(t(H), t(A), t(rng.standard_normal((B, n))), t(l), t(u),
                        t(0.1 * rng.standard_normal((B, n))),
                        t(0.1 * rng.standard_normal((B, m))),
                        t(0.1 * rng.standard_normal((B, m))))


@pytest.fixture(scope="module")
def cases():
    torch.set_num_threads(1)
    cold, warm, qpp = _walk_inputs()
    p = {k: torch.as_tensor(v) for k, v in _problem(np.float64).items()}
    kw = dict(iters=qpp.iterations, alpha=qpp.alpha)
    return {
        "walk": (warm, kw),
        "cold200": (cold, dict(kw, iters=200)),
        "resolving": (cold, dict(kw, iters=3)),
        "synthetic": (_scaled_case(p["H"], p["A"], p["g"], p["l"], p["u"], p["wx"],
                                   p["wz"], p["wy"]), kw),
        "odd": (_random_case(2, 9, 15, 72), kw),
        "above": (_random_case(2, 46, 75, 73), kw),
    }


def _cast(args, dtype):
    return tuple(a.to(dtype).contiguous() for a in args)


@pytest.mark.parametrize("reverse", [False, True], ids=["rising", "falling"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["walk", "cold200", "resolving", "synthetic", "odd",
                                  "above"])
def test_admm_zy_source_compiled_for_the_cpu_matches_plain(cases, case, dtype, reverse):
    args, kw = cases[case]
    args = _cast(args, dtype)
    n, m = args[1].shape[-1], args[1].shape[-2]
    in_registers = build.host_lib().qwbc_admm_zy_in_registers(n, m, args[1].element_size())
    assert in_registers == (case != "above" and dtype == torch.float32)
    want = admm_zy.admm_zy_iterations_res_plain(*args, **kw)
    got = admm_zy.admm_zy_iterations_res_host(*args, **kw, reverse=reverse)
    want64 = admm_zy.admm_zy_iterations_res_plain(*_cast(args, torch.float64), **kw)
    for name, g_, w_, w64 in zip("x z y pr du sv".split(), got, want, want64):
        assert g_.shape == w_.shape and g_.dtype == dtype, name
        if dtype == torch.float64:
            err = scaled_err(g_.numpy(), w_.numpy())
            assert err <= TOL64, (case, name, err)
        else:
            far = scaled_err(g_.numpy(), w64.numpy())
            bound = GUARD * scaled_err(w_.numpy(), w64.numpy()) + GUARD_ATOL
            assert far <= bound, (case, name, far, bound)
    pr, du = (w_.double() for w_ in want[3:5])
    if case == "resolving":        # far from converged: the residuals are held
        assert float(torch.maximum(pr, du).min()) > 1e-3
    elif case in ("walk", "cold200"):   # converged: an iteration that did nothing fails
        assert float(torch.maximum(pr, du).max()) < 1e-2
    if reverse:                    # the stages read nothing their own threads write
        again = admm_zy.admm_zy_iterations_res_host(*args, **kw, reverse=False)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_host_wrapper_refuses_a_shape_neither_instantiation_takes():
    n, m, B = 42, 1000, 1           # m + 2n threads: more than a block has
    z = lambda *s: torch.zeros(s, dtype=torch.float64)
    one = lambda *s: torch.ones(s, dtype=torch.float64)
    args = (z(B, n, n), z(B, m, n), z(B, n), z(B, m), z(B, m), one(B, m), z(B, n),
            z(B, m), z(B, m), z(B, n, n), z(B, m), z(B, m), one(B, n), one(B, m))
    with pytest.raises(ValueError, match="threads"):
        admm_zy.admm_zy_iterations_res_host(*args, iters=1, alpha=1.6)
