"""Weight and cache bridge: numpy trees in the JAX package's layout -> the
port's model state and decode cache.

The JAX package keeps each plan group's layers stacked ``[L, ...]`` in a
nested dict/list of arrays — QAT leaves (``w``, ``pbits``) from
``lm.init_params`` or serve leaves (``w4/w2/w1/perm/pbits_sorted/wscale``,
``b``) from ``convert_tree``. The port holds one module per layer, so
stacked leaves are unstacked here. Nothing of JAX is imported: callers
hand over numpy arrays (``jax.device_get``) or a checkpoint file.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "biuf":
        raise TypeError(f"unsupported leaf dtype {a.dtype}")
    return torch.tensor(a, device=device)      # a copy: leaves may be read-only


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map(v, fn) for v in node]
    return None if node is None else fn(node)


def params_from_numpy(tree: Dict, cfg, device: DeviceLike = None) -> lm.LM:
    """The JAX package's params tree (numpy leaves, stacked layer groups
    under ``groups``) -> an :class:`~repro_torch.models.lm.LM` on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    plan = cfg.layer_plan()
    if len(tree["groups"]) != len(plan):
        raise ValueError(f"{len(tree['groups'])} layer groups for plan "
                         f"{plan}")
    blocks = []
    for (_kind, count), group in zip(plan, tree["groups"]):
        for i in range(count):
            blocks.append(_map(group, lambda a, i=i: _tensor(a[i], dev)))
    out = {"embed": _map(tree["embed"], lambda a: _tensor(a, dev)),
           "final_norm": _map(tree["final_norm"],
                              lambda a: _tensor(a, dev)),
           "blocks": blocks}
    if "lm_head" in tree:
        out["lm_head"] = _map(tree["lm_head"], lambda a: _tensor(a, dev))
    return lm.LM(cfg, out)


def cache_from_numpy(tree: Dict, cfg, device: DeviceLike = None) -> Dict:
    """The JAX package's decode cache (numpy leaves, each plan group's
    layers stacked ``[L, ...]`` under ``groups``) -> the port's
    ``{"layers": [{"kv": {...}}]}`` on ``device``: fp ring, packed 4-bit
    ring or packed 4-bit page pool. The fp ring's ``pos`` becomes int64
    (the port's fp ring stamps); the paged layers share one page table,
    as the reference broadcasts one table to every layer."""
    dev = resolve_device(device)
    plan = cfg.layer_plan()
    if len(tree["groups"]) != len(plan):
        raise ValueError(f"{len(tree['groups'])} cache groups for plan "
                         f"{plan}")
    layers = []
    table = None
    for (_kind, count), group in zip(plan, tree["groups"]):
        kv = group["kv"]
        for i in range(count):
            layer = {name: _tensor(a[i], dev) for name, a in kv.items()}
            if "k" in layer:
                layer["pos"] = layer["pos"].long()
            if "page_table" in layer:
                if table is None:
                    table = layer["page_table"]
                elif not torch.equal(table, layer["page_table"]):
                    raise ValueError("paged layers disagree on the page "
                                     "table")
                layer["page_table"] = table
            layers.append({"kv": layer})
    return {"layers": layers}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    """{"a/b/0/c": x} -> {"a": {"b": [{"c": x}]}} (numeric parts index
    lists, as ``train/checkpoint.py`` writes list paths)."""
    root: Dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def load_npz(path: str, cfg, device: DeviceLike = None) -> lm.LM:
    """Load the path-flattened checkpoint the JAX package writes
    (``train/checkpoint.py``: ``<dir>/step_<N>/shard_0.npz``, keys like
    ``params/groups/0/attn/wq/w``). ``path`` is the npz file, a step
    directory, or a checkpoint directory (its ``LATEST`` step is read).
    The model is the ``params`` subtree of the saved state."""
    if os.path.isdir(path):
        latest = os.path.join(path, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                path = os.path.join(path, f"step_{int(f.read()):08d}")
        path = os.path.join(path, "shard_0.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_numpy(_unflatten(flat)["params"], cfg, device)
