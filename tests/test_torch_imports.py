"""The port stands alone: it imports torch, numpy and the standard library,
never jax and never the JAX package; and its kernel wrappers take the plain
version only for CPU tensors, with no fallback around the launch."""
import ast
import os

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = os.path.join(ROOT, "quadrupedwholebodycontroller_tpu_torch")
JAX_PKG = "quadrupedwholebodycontroller_tpu"


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PORT):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_jax_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax"), (path, mod)
        assert top != JAX_PKG, (path, mod)


def test_optional_packages_are_imported_inside_functions_only():
    """PyYAML and matplotlib are optional (the card's machine has no PyYAML):
    no module of the port, nor chip_smoke.py, imports them at module level,
    and the functions that need them do."""
    inside = set()
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        for node in top:
            names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                else [node.module or ""]
            assert not any(n.split(".")[0] in ("yaml", "matplotlib") for n in names), path
        for fn in (n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)):
            for node in ast.walk(fn):
                if isinstance(node, ast.Import):
                    inside.update(a.name.split(".")[0] for a in node.names)
    assert {"yaml", "matplotlib"} <= inside


def test_port_has_the_expected_modules():
    rel = {os.path.relpath(p, PORT) for p in _port_files()}
    for want in ("config.py", "convert.py", "control/wbc.py", "ops/qp.py",
                 "ops/linalg.py", "ops/compensated.py", "ops/kinematics.py",
                 "ops/dynamics.py", "ops/centroidal.py", "ops/spatial.py",
                 "ops/kernels/build.py", "ops/kernels/prepare.py",
                 "ops/kernels/admm_zy.py", "ops/kernels/admm.py",
                 "ops/kernels/polish.py", "ops/kernels/setup.py",
                 "ops/kernels/ns_warm.py", "replay.py",
                 "models/anymal.py", "models/robot_model.py",
                 "planner/gait.py", "planner/trot.py", "sim/world.py",
                 "sim/scenario.py", "sim/rollout.py", "parallel/mesh.py",
                 "parallel/sweep.py", "parallel/flagship.py", "runtime/checkpoint.py",
                 "runtime/native.py", "viz/plots.py", "cli/main.py"):
        assert want in rel, want
    for src in ("common.cuh", "prepare_tail.cuh", "admm_words.cuh", "prepare.cu",
                "admm_zy.cu", "admm.cu", "polish.cu", "setup.cu", "ns_warm.cu"):
        assert os.path.exists(os.path.join(PORT, "csrc", src)), src
    assert os.path.exists(os.path.join(PORT, "models", "data", "anymal_d.json"))


KERNEL_MODULES = ("prepare", "admm_zy", "admm", "polish", "setup", "ns_warm")


def test_prepare_and_setup_share_one_prepare_tail():
    """The Ruiz sweeps and the scaling live in one device function that both
    kernels call; neither source carries a copy."""
    read = lambda f: open(os.path.join(PORT, "csrc", f)).read()
    assert "void prepare_tail(" in read("prepare_tail.cuh")
    for src in ("prepare.cu", "setup.cu"):
        text = read(src)
        assert '#include "prepare_tail.cuh"' in text and "prepare_tail(" in text
        assert "s < sweeps" not in text and "rho_eq : rho0" not in text


def test_admm_kernels_share_one_epilogue():
    """The certificate is written once, as the per-warp helpers of
    common.cuh, which both ADMM kernels and the polish call; the two ADMM
    kernels share one register design, admm_words.cuh (the thread roles and
    each thread's matrix words); no kernel source carries a copy of either,
    nor the block-wide epilogue they replaced."""
    read = lambda f: open(os.path.join(PORT, "csrc", f)).read()
    words = read("admm_words.cuh")
    assert "struct ZyWords" in words and "ZyWho zy_who(" in words
    assert "void cert_finish(" in read("common.cuh")
    for src in ("admm_zy.cu", "admm.cu", "polish.cu"):
        text = read(src)
        assert "cert_warp_maxima(" in text and "cert_finish(" in text
        assert "kkt_epilogue(" not in text and "block_max(" not in text
        assert "1e-9" not in text and "1e19" not in text   # the certificate's tests
    for src in ("admm_zy.cu", "admm.cu"):
        text = read(src)
        assert '#include "admm_words.cuh"' in text
        assert "struct ZyWords" not in text and "zy_who(int" not in text
    for src in sorted(os.listdir(os.path.join(PORT, "csrc"))):
        text = read(src)
        assert "kkt_epilogue(" not in text and "block_max(" not in text, src
        if src != "admm_words.cuh":
            assert "struct ZyWords" not in text, src


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_wrappers_have_no_try_around_the_launch(name):
    """A CUDA tensor launches the kernel or raises: no `try` in the wrapper
    modules, so nothing can fall back to the plain version."""
    path = os.path.join(PORT, "ops", "kernels", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_kernel_sources_are_hand_written_cuda(name):
    """The .cu files call no library GEMM and name the kernel they replace."""
    with open(os.path.join(PORT, "csrc", f"{name}.cu")) as f:
        src = f.read()
    for banned in ("cublas", "cusolver", "cutlass", "torch/extension.h"):
        assert banned not in src.lower(), banned
    assert "__global__" in src and "Replaces the TPU kernel" in src
    assert "Bound on this card" in src


def _cpu_problem(B=3, n=6, m=8, k=2, start=2, dtype=torch.float64):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, dtype=dtype)
    L = r(B, n, n)
    H = L @ L.transpose(-1, -2) + n * torch.eye(n, dtype=dtype)
    A = r(B, m, n)
    l, u = -torch.ones(B, m, dtype=dtype), torch.ones(B, m, dtype=dtype)
    return H, A, r(B, n), l, u, r(B, n), r(B, m), r(B, m)


def test_cpu_tensors_take_the_plain_versions():
    from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams
    from quadrupedwholebodycontroller_tpu_torch.control import wbc
    from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
    from quadrupedwholebodycontroller_tpu_torch.ops import kernels
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import (
        admm, admm_zy, ns_warm, polish, prepare, setup)

    kernels.reset_counts()
    H, A, g, l, u, wx, wz, wy = _cpu_problem()
    B, m, n = A.shape
    out = prepare.prepare_scaled(H, A, g, l, u, wx, wz, wy, sweeps=2, rho0=0.5,
                                 rho_eq_scale=1000.0)
    sH, sA, sg, sl, su, rho, wxs, wzs, wys, d, e = out
    Kinv = torch.linalg.inv(sH + (sA.transpose(-1, -2) * rho[:, None, :]) @ sA)
    admm_zy.admm_zy_iterations_res(Kinv, sA, sg, sl, su, rho, wxs, wzs, wys, sH,
                                   l, u, d, e, iters=3, alpha=1.6)
    diag = torch.ones(B, n, dtype=H.dtype)
    diag[:, 2:4] = 0.0
    blk = torch.eye(2, dtype=H.dtype).expand(B, 2, 2).contiguous()
    da = torch.ones(B, m, dtype=H.dtype)
    Sinv = torch.eye(m, dtype=H.dtype).expand(B, m, m).contiguous()
    admm.admm_iterations_res(Kinv, sA, sg, sl, su, rho, wxs, wzs, wys, sH,
                             l, u, d, e, iters=3, sigma=1e-6, alpha=1.6)
    admm.admm_iterations(Kinv, sA, sg, sl, su, rho, wxs, wzs, wys,
                         iters=3, sigma=1e-6, alpha=1.6)
    polish.polish_solve((diag, blk, 2), (diag, blk, 2), Sinv, A, da, g, u, l, u,
                        refine=1, reg=1e-9)
    Hd = torch.diag_embed(diag + 1.0)
    polish.polish_solve(Hd, Hd, Sinv, A, da, g, u, l, u, refine=1, reg=1e-9)
    ns_warm.ns_inverse_warm(H, torch.linalg.inv(H), 2)
    obs = wbc.RobotObservation(
        base_R=torch.eye(3, dtype=H.dtype).expand(2, 3, 3), base_p=torch.zeros(2, 3, dtype=H.dtype),
        base_vel=torch.zeros(2, 6, dtype=H.dtype), q=torch.zeros(2, 12, dtype=H.dtype),
        qd=torch.zeros(2, 12, dtype=H.dtype))
    for exact in (False, True):
        setup.setup_batched(anymal_d_model(H.dtype, "cpu"), ControllerParams(), obs,
                            wbc.Reference.standing(ControllerParams(), 2, H.dtype, "cpu"),
                            wbc.init_carry(2, H.dtype, "cpu"), True, exact_mode=exact)
    assert kernels.plain_counts() == {
        "prepare_scaled": 1, "admm_zy_iterations_res": 1, "admm_iterations_res": 1,
        "admm_iterations": 1, "polish_solve_compact": 1, "polish_solve_dense": 1,
        "setup_batched": 1, "setup_batched_exact": 1, "ns_inverse_warm": 1}
    assert not any(kernels.launch_counts().values())
    assert len(kernels.launch_counts()) == 9


def test_unported_options_raise():
    """Every solver option of the JAX package runs on the port now (the
    name is the one the refusal's test had): each of the seven that ship
    off runs a control step on the kernel path, while an unknown setup or
    QP backend still raises a ValueError."""
    from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
    from quadrupedwholebodycontroller_tpu_torch.control import wbc
    from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
    from quadrupedwholebodycontroller_tpu_torch.ops import qp

    B, dt = 2, torch.float64
    model = anymal_d_model(dt, "cpu")
    carry = wbc.init_carry(B, dt, "cpu")
    ref = wbc.Reference.standing(ControllerParams(), B, dt, "cpu")
    obs = wbc.RobotObservation(
        base_R=torch.eye(3, dtype=dt).expand(B, 3, 3), base_p=torch.zeros(B, 3, dtype=dt),
        base_vel=torch.zeros(B, 6, dtype=dt), q=torch.zeros(B, 12, dtype=dt),
        qd=torch.zeros(B, 12, dtype=dt))
    cache = qp.make_cache(B, 42, 70, QPSolverParams(), dt, "cpu")
    step = lambda qpp=QPSolverParams(), cp=ControllerParams(), **kw: wbc.wbc_step_batched(
        model, cp, qpp, obs, ref, carry, True, kw.pop("qp_backend", "kernel"),
        kw.pop("qp_cache", cache), False, **kw)
    with pytest.raises(ValueError, match="setup_backend"):
        step(setup_backend="pallas")
    for opt in (dict(comp_final_refine=1), dict(drop_warm_iters=4), dict(cond_hoist=1),
                dict(drop_fire_tol=1e-3), dict(drop_sinv_refresh=1), dict(drop_ns_iters=5),
                dict(drop_approx_rank=1)):
        out, _, _ = step(QPSolverParams(**opt))
        assert bool(torch.isfinite(out.tau).all()), opt
    # the torch backend (the JAX package's "xla" path) runs; a backend of
    # neither name is a ValueError
    with pytest.raises(ValueError, match="qp_backend"):
        step(qp_backend="xla")
    assert len(step(qp_backend="torch")) == 3
    H, A, g, l, u = _cpu_problem()[:5]
    data, warm = qp.QPData(H=H, g=g, A=A, l=l, u=u), qp.QPState.zeros(3, 6, 8, torch.float64,
                                                                       "cpu")
    assert len(qp.solve_batched(data, warm, backend="torch")) == 2
    with pytest.raises(ValueError, match="backend"):
        qp.solve_batched(data, warm, backend="xla")
    # sigma > 0, a warm-iterated polish Schur inverse, a step without a
    # cache and exact derivatives (every setup route) are ported now: they run
    for ok in (dict(sigma=1e-6), dict(ns_warm_iters_polish=1)):
        assert len(step(QPSolverParams(**ok))) == 3
    assert len(step(qp_cache=None)) == 2
    for backend in ("auto", "kernel", "torch"):
        for epilogue in (False, True):
            cp = ControllerParams(exact_derivatives=True, exact_epilogue=epilogue)
            assert len(step(setup_backend=backend, cp=cp)) == 3


def test_tf32_matmul_is_off():
    import quadrupedwholebodycontroller_tpu_torch.ops.linalg  # noqa: F401  (checks at import)

    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_exact_setup_takes_the_plain_version_only_for_cpu_tensors():
    """The exact mode's wrapper branches on the tensors' device alone: a CPU
    tensor runs `wbc_setup`'s exact branch and counts a plain call under its
    own name; no `NotImplementedError` is left for exact derivatives (none
    is left in the control step at all: both QP backends are ported)."""
    import inspect

    from quadrupedwholebodycontroller_tpu_torch.control import wbc
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup

    src = inspect.getsource(setup.setup_batched)
    assert 'device.type == "cpu"' in src and "setup_batched_plain" in src
    assert "NotImplementedError" not in inspect.getsource(setup)
    wsrc = inspect.getsource(wbc)
    raises = [wsrc[i:i + 160] for i in range(len(wsrc))
              if wsrc.startswith("raise NotImplementedError", i)]
    assert not any("exact" in r for r in raises)
    assert set(setup.LAUNCHES) == {"setup_batched", "setup_batched_exact"}
