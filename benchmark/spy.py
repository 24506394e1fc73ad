"""Launch records of the solver and setup kernels, taken by wrapping the
port's kernel wrappers while a traced segment runs: per call the kernel's
name, its batch and the operations and bytes that call needs
(`benchmark/roofline.py`).  Pure Python over shapes: no launch, no sync.

A wrapper the port no longer has is left alone, and the roofline metric
that reads it then finds nothing to read.
"""
from __future__ import annotations

import contextlib
import importlib

from benchmark import roofline as R

PORT = "quadrupedwholebodycontroller_tpu_torch"


def _tensors(args):
    for a in args:
        if isinstance(a, tuple):
            yield from _tensors(a)
        elif hasattr(a, "numel") and hasattr(a, "element_size"):
            yield a


def _admm_zy(record, fn):
    def spy(*args, iters, alpha):
        outs = fn(*args, iters=iters, alpha=alpha)
        B = args[1].shape[0]
        record(R.K1, B, R.flops_of(R.K1, B, {"iters": iters}),
               R.nbytes(_tensors(args)) + R.nbytes(outs))
        return outs
    return spy


def _polish(record, fn):
    def spy(H, Hinv, *rest, refine, reg):
        outs = fn(H, Hinv, *rest, refine=refine, reg=reg)
        if isinstance(H, tuple):        # the compact form, K2 (not the dense K7)
            B = rest[1].shape[0]
            record(R.K2, B, R.flops_of(R.K2, B, {"refine": refine}),
                   R.nbytes(_tensors((H, Hinv) + rest)) + R.nbytes(outs))
        return outs
    return spy


def _setup(record, fn):
    def spy(model, params, obs, ref, carry, ref_is_new, qp_params=None, exact_mode=False,
            stop_after=None):
        res = fn(model, params, obs, ref, carry, ref_is_new, qp_params=qp_params,
                 exact_mode=exact_mode, stop_after=stop_after)
        if stop_after is None and not exact_mode:
            B = obs.q.shape[0]
            cu = res["carry_updates"]
            outs = [res[k] for k in ("H", "g", "A", "l", "u", "h_c", "Mc_jj", "Jc_st_j",
                                     "com", "current_pose", "foot_pos")]
            outs += [cu[k] for k in ("old_T", "old_J_st", "old_J_sw", "tdot_inv",
                                     "integral_error", "prev_contacts")]
            outs += list(res["prepared"] or ())
            record(R.K3, B, R.flops_of(R.K3, B, {"qp_params": qp_params}),
                   R.setup_bytes(obs, ref, carry, B, outs, qp_params is not None))
        return res
    return spy


# (module under the port, wrapper name, spy factory)
WRAPPERS = (("ops.kernels.admm_zy", "admm_zy_iterations_res", _admm_zy),
            ("ops.kernels.polish", "polish_solve", _polish),
            ("ops.kernels.setup", "setup_batched", _setup))


class LaunchSpy:
    """`with spy.active():` records every launch of the wrapped kernels in
    `records`: (name, batch, flops, bytes)."""

    def __init__(self):
        self.records = []

    def _record(self, name, batch, flops, nbytes):
        self.records.append((name, batch, flops, nbytes))

    @contextlib.contextmanager
    def active(self):
        patched = []
        try:
            for mod_name, attr, factory in WRAPPERS:
                try:
                    mod = importlib.import_module(f"{PORT}.{mod_name}")
                except ImportError:
                    continue
                fn = getattr(mod, attr, None)
                if fn is None:
                    continue
                setattr(mod, attr, factory(self._record, fn))
                patched.append((mod, attr, fn))
            yield self
        finally:
            for mod, attr, fn in patched:
                setattr(mod, attr, fn)

    def bound_seconds(self, name: str) -> float:
        return sum(R.bound_seconds(f, b) for n, _, f, b in self.records if n == name)

    def launches(self, name: str) -> int:
        return sum(1 for n, *_ in self.records if n == name)
