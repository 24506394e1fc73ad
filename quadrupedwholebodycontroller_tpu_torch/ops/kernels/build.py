"""Builds `csrc/*.cu` into one shared library at first use and loads it.

The kernels have a plain C interface, so the build is `nvcc` by hand (one
compile per source, all started together, then one link) and the binding is
`ctypes`: seconds, where a build against PyTorch's headers takes minutes.
The library goes into `build/` beside the package, named after a hash of
the sources and flags, so an unchanged tree builds once.  A failed build raises with the compiler's
output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = ("prepare.cu", "admm_zy.cu", "admm.cu", "polish.cu", "setup.cu", "ns_warm.cu")
HEADERS = ("common.cuh", "prepare_tail.cuh", "admm_words.cuh")
# the objects of the device build: every source once, and setup.cu a second
# time with its section probes alone (see there), compiled beside the others
OBJECTS = tuple((name, name[:-3], ()) for name in SOURCES) + (
    ("setup.cu", "setup_sections", ("-DQWBC_SETUP_SECTIONS",)),)
# sources written with the stage macros of common.cuh alone, which also
# compile as plain C++ (see `host_lib`)
HOST_SOURCES = ("setup.cu", "ns_warm.cu", "polish.cu", "admm_zy.cu", "admm.cu")
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SMEM_BYTES = 232_448   # shared memory one block may use on an H100

_lib = None
_host_lib = None
build_seconds = None   # wall time of the build this process ran, if any
build_log = ""         # what nvcc printed (register / shared-memory use)
object_seconds = {}    # object -> seconds from the build's start to its compile's end


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "qwbc_torch_kernels")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of this package are compiled at "
        "first use and need the CUDA toolkit (looked on PATH and under "
        "$CUDA_HOME, /usr/local/cuda)"
    )


def _source_hash(flags=NVCC_FLAGS, sources=SOURCES) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(lib_path: str) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src, name, extra in OBJECTS:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", CSRC_DIR, "-c",
                   os.path.join(CSRC_DIR, src), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs, logs, failed = [], [], []
        for name, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            object_seconds[name] = time.perf_counter() - t0
            if p.returncode != 0:
                failed.append(name)
            objs.append(obj)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)   # atomic: a concurrent build wins or loses whole
    build_seconds = time.perf_counter() - t0


def ptxas_report(source: str) -> list:
    """What ptxas printed for the kernels of one object ("setup" for
    setup.cu, "setup_sections" for its probes) in the build this process
    ran (empty if it loaded an earlier build): one dict a kernel,
    {"kernel", "registers", "stack_bytes", "spill_store_bytes",
    "spill_load_bytes"}; the kernel named as mangled, trimmed of the
    namespace and the argument list."""
    name = source[:-3] if source.endswith(".cu") else source
    section = build_log.split(f"== {name}\n", 1)[-1].split("\n== ", 1)[0] \
        if f"== {name}\n" in build_log else ""
    out = []
    for ln in section.splitlines():
        if m := re.search(r"Compiling entry function '(?:_ZN4qwbc\d+)?(\w+?)(?:Ev|EEv)", ln):
            out.append({"kernel": m.group(1)})
        elif out and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                     r"(\d+) bytes spill loads", ln)):
            out[-1].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
        elif out and (m := re.search(r"Used (\d+) registers", ln)):
            out[-1]["registers"] = int(m.group(1))
    return out


_PTR = ctypes.c_void_p


def _declare(lib) -> None:
    i, f, d = ctypes.c_int, ctypes.c_float, ctypes.c_double
    for suffix, real in (("f32", f), ("f64", d)):
        fn = getattr(lib, f"qwbc_prepare_{suffix}")
        fn.argtypes = [_PTR] * 19 + [i, i, i, i, real, real, _PTR]
        fn.restype = i
        _declare_admm_zy(lib, suffix, real)
        _declare_admm(lib, suffix, real)
        _declare_polish(lib, suffix, real)
        _declare_setup(lib, suffix, real)
        _declare_ns_warm(lib, suffix)
    lib.qwbc_error_string.argtypes = [i]
    lib.qwbc_error_string.restype = ctypes.c_char_p


def _declare_admm_zy(lib, suffix, real) -> None:
    i = ctypes.c_int
    fn = getattr(lib, f"qwbc_admm_zy_{suffix}")
    # pointers, B, n, m, iters, alpha, 1 - alpha, w0, 1 - w0, stream
    fn.argtypes = [_PTR] * 20 + [i, i, i, i, real, real, real, real, _PTR]
    fn.restype = i
    # the instantiation a shape and element size take, the threads, the
    # shared memory in words
    for name, args, res in (("in_registers", 3, i), ("threads", 2, i),
                            ("words", 3, ctypes.c_size_t)):
        fn = getattr(lib, f"qwbc_admm_zy_{name}")
        fn.argtypes = [i] * args
        fn.restype = res


def _declare_admm(lib, suffix, real) -> None:
    i = ctypes.c_int
    fn = getattr(lib, f"qwbc_admm_{suffix}")
    # pointers, B, n, m, iters, epilogue, sigma, alpha, 1 - alpha, stream
    fn.argtypes = [_PTR] * 20 + [i, i, i, i, i, real, real, real, _PTR]
    fn.restype = i
    # the shared memory in words of a shape, element size and epilogue flag
    lib.qwbc_admm_words.argtypes = [i, i, i, i]
    lib.qwbc_admm_words.restype = ctypes.c_size_t


def _declare_setup(lib, suffix, real) -> None:
    i = ctypes.c_int
    fn = getattr(lib, f"qwbc_setup_{suffix}")
    # pointer table, its length, the constant tables' lengths, B, the stride
    # of ref_is_new, exact, fused, sweeps, rho0, rho_eq, stream
    fn.argtypes = [ctypes.POINTER(_PTR), i, i, i, i, i, i, i, i, real, real, _PTR]
    fn.restype = i
    if suffix == "f32":
        # the section probes: the same table, B, stride, exact, stop_after, stream
        fn = lib.qwbc_setup_sections_f32
        fn.argtypes = [ctypes.POINTER(_PTR), i, i, i, i, i, i, i, _PTR]
        fn.restype = i


def _declare_polish(lib, suffix, real) -> None:
    i = ctypes.c_int
    fn = getattr(lib, f"qwbc_polish_{suffix}")
    # pointers, B, n, m, k, start, refine, reg, stream
    fn.argtypes = [_PTR] * 17 + [i, i, i, i, i, i, real, _PTR]
    fn.restype = i
    fn = getattr(lib, f"qwbc_polish_dense_{suffix}")
    # pointers, B, n, m, refine, reg, stream
    fn.argtypes = [_PTR] * 15 + [i, i, i, i, real, _PTR]
    fn.restype = i
    # a block's shared memory in words: compact from n, m, k; dense from n, m
    lib.qwbc_polish_compact_words.argtypes = [i, i, i]
    lib.qwbc_polish_compact_words.restype = ctypes.c_size_t
    lib.qwbc_polish_dense_words.argtypes = [i, i]
    lib.qwbc_polish_dense_words.restype = ctypes.c_size_t


def _declare_ns_warm(lib, suffix) -> None:
    i = ctypes.c_int
    fn = getattr(lib, f"qwbc_ns_warm_{suffix}")
    fn.argtypes = [_PTR, _PTR, _PTR, i, i, i, _PTR]   # A, W, X, B, n, iters, stream
    fn.restype = i


def lib():
    """The loaded kernel library, built first if this tree's build is missing."""
    global _lib
    if _lib is None:
        path = os.path.join(build_dir(), f"libqwbc_kernels_{_source_hash()}.so")
        if not os.path.exists(path):
            _build(path)
        loaded = ctypes.CDLL(path)
        _declare(loaded)
        _lib = loaded
    return _lib


def host_lib():
    """`HOST_SOURCES` compiled as plain C++ by the host's compiler (one
    compile per source, all started together, then one link), where a
    block is one thread that runs each stage's items in turn: the kernels'
    own arithmetic, checked without a GPU (tests only; nothing on a
    device path calls it).  Raises if there is no C++ compiler."""
    global _host_lib
    if _host_lib is None:
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (looked for g++, c++)")
        path = os.path.join(
            build_dir(), f"libqwbc_host_{_source_hash(HOST_FLAGS, HOST_SOURCES)}.so")
        if not os.path.exists(path):
            os.makedirs(build_dir(), exist_ok=True)
            with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
                objs = [os.path.join(tmp, n + ".o") for n in HOST_SOURCES]
                procs = [subprocess.Popen(
                    [cxx, *HOST_FLAGS, "-I", CSRC_DIR, "-c", os.path.join(CSRC_DIR, n),
                     "-o", o], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                    for n, o in zip(HOST_SOURCES, objs)]
                outs = [p.communicate()[0] for p in procs]
                if any(p.returncode != 0 for p in procs):
                    raise RuntimeError(f"{cxx} failed:\n" + "\n".join(outs))
                tmp_lib = os.path.join(tmp, "lib.so")
                run = subprocess.run([cxx, "-shared", "-o", tmp_lib, *objs],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
                if run.returncode != 0:
                    raise RuntimeError(f"{cxx} link failed:\n{run.stdout}")
                os.replace(tmp_lib, path)
        loaded = ctypes.CDLL(path)
        for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            _declare_setup(loaded, suffix, real)
            _declare_ns_warm(loaded, suffix)
            _declare_polish(loaded, suffix, real)
            _declare_admm_zy(loaded, suffix, real)
            _declare_admm(loaded, suffix, real)
        _host_lib = loaded
    return _host_lib


def launch(name: str, dtype_suffix: str, *args) -> None:
    """Call one C launcher; raise if the launch was refused.

    The launch is asynchronous on PyTorch's current stream.  Temporaries
    the wrapper passes (clipped bounds) may be freed by Python before the
    kernel runs: PyTorch's allocator hands such memory only to later work
    on the same stream, so the kernel still reads what it was given."""
    l = lib()
    err = getattr(l, f"qwbc_{name}_{dtype_suffix}")(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA launch of {name}_{dtype_suffix} failed: "
            f"{l.qwbc_error_string(err).decode()} (code {err})"
        )


def _requires_grad(x) -> bool:
    """Whether a tensor in x (a tensor, a tuple, list or dict of them, or a
    dataclass such as a RobotModel or ControllerParams) requires grad."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.requires_grad
    if isinstance(x, (tuple, list)):
        return any(_requires_grad(t) for t in x)
    if isinstance(x, dict):
        return any(_requires_grad(t) for t in x.values())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return any(_requires_grad(getattr(x, f.name)) for f in dataclasses.fields(x))
    return False


def refuse_grad(name: str, *inputs, hint: str = "") -> None:
    """Raise before anything launches when grad mode is on and an input
    requires grad, on either device (the CPU's plain version too), so that
    the kernel path's contract is the same here and on the card.  `hint`,
    an entry point's, says which of its options carries a gradient."""
    import torch

    if torch.is_grad_enabled() and _requires_grad(inputs):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernels have no backward, as "
            "the JAX package's Pallas kernels have none (jax.grad through a "
            "pl.pallas_call raises).  " + (f"{hint}.  " if hint else "")
            + "For a value alone, call under torch.no_grad().")


def check_inputs(ref, named_shapes: dict, device_type: str = "cuda") -> str:
    """Raise unless every tensor is a contiguous CUDA tensor of ref's device
    and dtype with the stated shape; returns the launcher's dtype suffix.
    (`device_type="cpu"`: the same check for `host_lib`.)"""
    import torch

    if ref.dtype == torch.float32:
        suffix = "f32"
    elif ref.dtype == torch.float64:
        suffix = "f64"
    else:
        raise TypeError(f"kernels take float32 or float64, got {ref.dtype}")
    for name, (t, shape) in named_shapes.items():
        if t.device != ref.device or t.device.type != device_type:
            raise ValueError(f"{name}: on {t.device}, expected {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: {t.dtype}, expected {ref.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    return suffix
