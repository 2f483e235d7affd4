"""Atomic, resumable checkpoints in the JAX package's format. Counterpart
of ``repro.train.checkpoint``; a checkpoint written by either package
restores in the other.

Layout:  <dir>/step_<N:08d>/
             manifest.json       step, time, every leaf's shape and dtype,
                                 the None leaves
             shard_<host>.npz    the leaves, keyed by tree path
                                 (``params/groups/0/attn/wq/w``)
         <dir>/LATEST            the newest step, replaced atomically

A save writes into a temporary directory and renames it (atomic on
POSIX), so a crash mid-save never corrupts the restore target; the
oldest steps beyond ``keep`` are removed. The trees are nested dicts and
lists of numpy arrays, tensors or None: a train state crosses through
``interop.state_to_tree`` / ``interop.state_from_tree``. bf16 leaves are
stored as the reference's npz holds them (two raw bytes a value, dtype
``bfloat16`` in the manifest) and restored as bf16 tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.interop import flatten_tree, host_copy, unflatten_tree


def _host(leaf) -> Optional[np.ndarray]:
    """A tensor leaf copied to host memory (never a view of a tensor the
    next step updates in place); numpy leaves as they are."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        return host_copy(leaf)
    return np.asarray(leaf)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)


def snapshot(tree) -> Dict[str, Optional[np.ndarray]]:
    """The flattened tree with every tensor leaf copied to host memory."""
    return {k: _host(v) for k, v in flatten_tree(tree).items()}


def _write(flat: Dict[str, Optional[np.ndarray]], ckpt_dir: str, step: int,
           host_id: int, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp{host_id}"
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: v for k, v in flat.items() if v is not None}
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                   for k, v in arrays.items()},
        "none_leaves": [k for k, v in flat.items() if v is None],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def save(state, ckpt_dir: str, step: int, *, host_id: int = 0,
         keep: int = 3) -> str:
    """Write ``state`` (a tree) as step ``step``; returns its directory."""
    return _write(snapshot(state), ckpt_dir, step, host_id, keep)


def async_save(state, ckpt_dir: str, step: int, *, host_id: int = 0,
               keep: int = 3) -> threading.Thread:
    """Copy every leaf to host memory now (the caller may update its
    tensors in place as soon as this returns); write on a background
    thread. Join the thread before relying on the checkpoint."""
    flat = snapshot(state)
    t = threading.Thread(target=_write,
                         args=(flat, ckpt_dir, step, host_id, keep),
                         daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _restore_leaf(a: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def restore(ckpt_dir: str, template=None, *, step: Optional[int] = None,
            host_id: int = 0) -> Tuple[Any, int]:
    """(tree, step) of step ``step`` (default: ``LATEST``). With a
    ``template`` tree, the structure is the template's (its None leaves
    stay None, every other leaf must be in the file with the template's
    shape); without one, the file's own tree. Leaves come back as numpy
    arrays (bf16 ones as CPU tensors)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, f"shard_{host_id}.npz")) as z:
        arrays = {k: _restore_leaf(z[k], manifest["leaves"][k]["dtype"])
                  for k in z.files}
    if template is None:
        flat: Dict[str, Any] = dict.fromkeys(manifest["none_leaves"])
        flat.update(arrays)
        return unflatten_tree(flat), step
    flat = {}
    for key, leaf in flatten_tree(template).items():
        if leaf is None:
            flat[key] = None
            continue
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)}, "
                             f"template {tuple(leaf.shape)}")
        flat[key] = arr
    return unflatten_tree(flat), step


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp0"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
