"""ctypes bindings to the first-party native library (`native/` at the
root of the repository):

  * the dynamics oracle: an independent C++ Featherstone CRBA / RNEA and
    WBC QP assembly, the trusted cross-check of the port's rigid-body code
    (the role iDynTree plays for the reference controller);
  * the trajectory log: a host-side binary recorder (the reference's
    rosbag record).

The library is built at first use with `make` (g++) into `build/` beside
the package, apart from any other build of it.  A failed build or load
raises with the build's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from functools import lru_cache

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "qwbc_torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libqwbc_native.so")


@lru_cache(maxsize=1)
def load():
    """Build the library if needed (one build at a time, under a file lock)
    and load it; raises RuntimeError if either fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(LIB_PATH):
            r = subprocess.run(["make", "-C", NATIVE_DIR, f"BUILD={BUILD_DIR}"],
                               capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                raise RuntimeError(f"building the native library failed:\n{r.stdout}\n{r.stderr}")
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as e:
        raise RuntimeError(f"loading {LIB_PATH} failed: {e}") from e

    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.qwbc_mass_and_bias.argtypes = [ctypes.c_int, ip] + [dp] * 11
    lib.qwbc_mass_and_bias.restype = None
    lib.qwbc_qp_assembly.argtypes = (
        [ctypes.c_int, ip] + [dp] * 6 + [ctypes.c_int, ip] + [dp] * 7
        + [ctypes.c_int, ctypes.c_int] + [dp] * 2
    )
    lib.qwbc_qp_assembly.restype = None
    lib.qwbc_trajlog_create.argtypes = [ctypes.c_uint32, ctypes.c_uint64]
    lib.qwbc_trajlog_create.restype = ctypes.c_void_p
    lib.qwbc_trajlog_append_many.argtypes = [ctypes.c_void_p, dp, ctypes.c_uint64]
    lib.qwbc_trajlog_append_many.restype = None
    lib.qwbc_trajlog_num_frames.argtypes = [ctypes.c_void_p]
    lib.qwbc_trajlog_num_frames.restype = ctypes.c_uint64
    lib.qwbc_trajlog_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.qwbc_trajlog_flush.restype = ctypes.c_int
    lib.qwbc_trajlog_read.argtypes = [
        ctypes.c_char_p, dp, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32)
    ]
    lib.qwbc_trajlog_read.restype = ctypes.c_int64
    lib.qwbc_trajlog_destroy.argtypes = [ctypes.c_void_p]
    lib.qwbc_trajlog_destroy.restype = None
    return lib


def _f64(x):
    """A contiguous float64 numpy copy of a tensor, array or sequence."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=np.float64)


def _i32(x):
    return np.ascontiguousarray(np.asarray(x), dtype=np.int32)


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check(name, a, shape):
    if a.shape != shape:
        raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
    return a


def oracle_mass_and_bias(model, base_R, q, u):
    """The C++ Featherstone M(q) (nv, nv) and Coriolis bias (nv,), mixed
    representation, as float64 numpy, for one configuration: base_R (3, 3),
    q (nj,), u (nv,); a shared `model` of any dtype and device."""
    lib = load()
    nb, nv = model.num_bodies, model.nv
    keep = [_f64(getattr(model, k)) for k in
            ("joint_R", "joint_p", "joint_axis", "mass", "com", "inertia")]
    _check("mass", keep[3], (nb,))
    state = [_check("base_R", _f64(base_R), (3, 3)), _check("q", _f64(q), (nv - 6,)),
             _check("u", _f64(u), (nv,))]
    parent = _i32(model.parent)
    M, h = np.zeros((nv, nv)), np.zeros(nv)
    lib.qwbc_mass_and_bias(nb, _iptr(parent), *(_dptr(a) for a in keep + state),
                           _dptr(M), _dptr(h))
    return M, h


_ASSEMBLY_OUT = (("H", (42, 42)), ("g", (42,)), ("A", (70, 42)), ("l", (70,)), ("u", (70,)),
                 ("h_c", (18,)), ("T", (18, 18)), ("Jc_st", (12, 18)), ("Jc_sw", (12, 18)),
                 ("tdot_inv", (18, 18)), ("integral_error", (6,)))


def oracle_qp_assembly(model, params, obs, ref, carry, switch_flag, deriv_valid):
    """The C++ re-derivation of the whole WBC QP assembly (the reference's
    whole_body_controller.cpp:256-320, 384-515; the port's
    `control.wbc.wbc_setup`) for one robot: obs a RobotObservation, ref a
    Reference (contacts resolved), carry a WBCCarry (qp_warm unused), each
    leaf unbatched.  Returns a dict of float64 numpy arrays: the QP data and
    the carry updates (H, g, A, l, u, h_c, T, Jc_st, Jc_sw, tdot_inv,
    integral_error), for chaining cycles."""
    lib = load()
    refs = np.concatenate([_f64(getattr(ref, k)) for k in
                           ("com_pose", "com_vel", "com_acc", "swing_pos", "swing_vel",
                            "swing_acc", "contacts")])
    carry_packed = np.concatenate([_f64(getattr(carry, k)).ravel() for k in
                                   ("old_T", "old_J_st", "old_J_sw", "tdot_inv",
                                    "integral_error")])
    par = np.array([params.kp, params.kp_z, params.kd, params.ki, params.kp_swing,
                    params.kd_swing, params.friction, params.max_torque,
                    params.slack_weight, params.loop_rate, 1.0e20])
    _check("refs", refs, (58,))
    _check("carry", carry_packed, (324 + 216 + 216 + 324 + 6,))
    outs = np.zeros(sum(int(np.prod(s)) for _, s in _ASSEMBLY_OUT))
    parent, frame_body = _i32(model.parent), _i32(model.frame_body)
    arrays = [_f64(getattr(model, k)) for k in
              ("joint_R", "joint_p", "joint_axis", "mass", "com", "inertia")]
    frame_p = _f64(model.frame_p)
    state = [_f64(obs.base_R), _f64(obs.base_p), _f64(obs.q),
             np.concatenate([_f64(obs.base_vel), _f64(obs.qd)])]
    lib.qwbc_qp_assembly(
        model.num_bodies, _iptr(parent), *(_dptr(a) for a in arrays),
        len(model.frame_body), _iptr(frame_body), _dptr(frame_p),
        *(_dptr(a) for a in state), _dptr(refs), _dptr(carry_packed),
        int(switch_flag), int(deriv_valid), _dptr(par), _dptr(outs))
    o, out = 0, {}
    for name, shape in _ASSEMBLY_OUT:
        n = int(np.prod(shape))
        out[name] = outs[o:o + n].reshape(shape)
        o += n
    return out


class TrajLog:
    """Host-side binary trajectory recorder: frames of `frame_doubles`
    float64 values, kept in memory and written to disk at `flush`."""

    def __init__(self, frame_doubles: int, reserve_frames: int = 1 << 16):
        self._lib = load()
        self._frame_doubles = frame_doubles
        self._handle = self._lib.qwbc_trajlog_create(frame_doubles, reserve_frames)

    def append(self, frames):
        frames = _f64(frames)
        n = frames.size // self._frame_doubles
        if frames.size != n * self._frame_doubles:
            raise ValueError(f"{frames.size} values are not whole frames of "
                             f"{self._frame_doubles}")
        self._lib.qwbc_trajlog_append_many(self._handle, _dptr(frames), n)

    def __len__(self):
        return int(self._lib.qwbc_trajlog_num_frames(self._handle))

    def flush(self, path: str):
        rc = self._lib.qwbc_trajlog_flush(self._handle, path.encode())
        if rc != 0:
            raise IOError(f"trajlog flush to {path} failed: {rc}")

    def close(self):
        if self._handle:
            self._lib.qwbc_trajlog_destroy(self._handle)
            self._handle = None

    @staticmethod
    def read(path: str) -> np.ndarray:
        """(frames, frame_doubles) float64 from a flushed log."""
        lib = load()
        fd = ctypes.c_uint32()
        n = lib.qwbc_trajlog_read(path.encode(), None, 0, ctypes.byref(fd))
        if n < 0:
            raise IOError(f"trajlog read of {path} failed: {n}")
        out = np.zeros(n * fd.value)
        lib.qwbc_trajlog_read(path.encode(), _dptr(out), out.size, None)
        return out.reshape(n, fd.value)
