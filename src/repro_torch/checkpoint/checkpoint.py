"""Atomic, resumable, corruption-detecting checkpoints.

Counterpart of ``repro/checkpoint/checkpoint.py``, with its directory
layout, leaf names and manifest, so that a checkpoint written by either
package restores in the other:

  save():    write everything into ``<dir>/step_<n>.tmp/`` (one ``.npy``
             per leaf + ``manifest.json`` with each leaf's shape, dtype and
             ``sha256[:16]`` of its bytes), fsync, then atomically rename
             to ``<dir>/step_<n>/``.  A crash mid-save leaves only a
             ``.tmp`` dir that restore() ignores and the next save()
             replaces.
  restore(): picks the latest complete step dir and verifies every leaf's
             checksum before handing anything back; a corrupted leaf raises.
  latest_step(): discovery for auto-resume.

Trees are nested dicts (keys sorted, as JAX flattens them), lists / tuples
(by index) and leaves (numpy arrays or tensors, saved as host numpy).  A
leaf's name joins its keys with ``__``; the reference's ``Quant8`` has two
children, so a ``(q, hi)`` pair here is named ``<leaf>__0`` / ``<leaf>__1``
as there.  The port's train state crosses through
``models.convert.train_state_to_numpy`` / ``train_state_from_numpy``.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np
import torch


def _leaf_files(tree, prefix: tuple = ()):
    """``(name, leaf)`` in the reference's flatten order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaf_files(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaf_files(item, prefix + (i,))
    else:
        name = "__".join(re.sub(r"[^A-Za-z0-9_.-]", "_", str(p))
                         for p in prefix) or "root"
        yield name, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def save(ckpt_dir: str, step: int, tree) -> str:
    """Atomic save; returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": int(step), "leaves": {}}
    for name, leaf in _leaf_files(tree):
        arr = _host(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha": _checksum(arr),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Largest complete step; .tmp dirs (crashed saves) are ignored."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _rebuild(tree_like, leaves):
    if isinstance(tree_like, dict):
        return {k: _rebuild(tree_like[k], leaves) for k in sorted(tree_like)}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_rebuild(x, leaves) for x in tree_like)
    return next(leaves)


def restore(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like`` (its leaves are not
    read); verifies checksums.

    Returns (step, tree) with numpy leaves.  Raises on corruption or
    missing leaves.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    leaves = []
    for name, _ in _leaf_files(tree_like):
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(os.path.join(d, name + ".npy"))
        if _checksum(arr) != meta["sha"]:
            raise IOError(f"checkpoint corruption detected in leaf {name!r}")
        leaves.append(arr)
    return step, _rebuild(tree_like, iter(leaves))
