"""Checkpoint and resume for long scenario sweeps.

The reference keeps no state across runs (its recordings are logs, not
checkpoints).  A long batched sweep saves its whole rollout carry (the
simulator state, the WBC carry with the QP warm start, the planner state,
the held reference), a tree of NamedTuples of tensors, as one npz: the
leaves in order plus a description of the tree, so that a resumed sweep
continues bit for bit.
"""
from __future__ import annotations

import json

import numpy as np
import torch


def _flatten(tree, leaves: list) -> str:
    """Appends the tensor leaves of `tree` to `leaves`; returns the tree's
    structure (types, field names, leaf shapes) as a string."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return f"T{tuple(tree.shape)}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ", ".join(f"{k}={_flatten(v, leaves)}" for k, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, (tuple, list)):
        return f"{type(tree).__name__}[{', '.join(_flatten(v, leaves) for v in tree)}]"
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree))
        return f"dict{{{inner}}}"
    return repr(tree)


def _unflatten(like, it):
    if isinstance(like, torch.Tensor):
        return next(it)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, it) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, it) for v in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    return like


def save_pytree(path: str, tree, meta: dict | None = None):
    """Writes the tensors of `tree` (nested NamedTuples, tuples, lists and
    dicts of tensors) and its structure to the npz `path`, with an optional
    JSON-able `meta`."""
    leaves = []
    structure = _flatten(tree, leaves)
    payload = {f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)}
    payload["__structure__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    if meta:
        payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **payload)


def load_pytree(path: str, like):
    """The tree saved at `path`, in the structure of `like`, each leaf with
    the dtype and device of `like`'s; a ValueError if the saved structure
    (types, fields, leaf shapes) is not `like`'s."""
    like_leaves = []
    structure = _flatten(like, like_leaves)
    with np.load(path) as f:
        saved = bytes(f["__structure__"]).decode()
        if saved != structure:
            raise ValueError(f"checkpoint structure mismatch:\n saved: {saved}\n"
                             f" expected: {structure}")
        arrays = [f[f"leaf_{i}"] for i in range(len(like_leaves))]
    leaves = [torch.as_tensor(a).to(dtype=l.dtype, device=l.device)
              for a, l in zip(arrays, like_leaves)]
    return _unflatten(like, iter(leaves))


def load_meta(path: str) -> dict:
    with np.load(path) as f:
        if "__meta__" not in f:
            return {}
        return json.loads(bytes(f["__meta__"]).decode())
