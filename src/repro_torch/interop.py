"""Weight, train-state and cache bridge between numpy trees in the JAX
package's layout and the port's model, train state and decode cache; and
the weight bridge of a single linear and of the CNN (the reference's
``linear_init`` leaf and ``cnn_init`` tree, in any phase).

The JAX package keeps each plan group's layers stacked ``[L, ...]`` in a
nested dict/list of arrays (an encoder-decoder's encoder layers too, under
``enc_groups``; a hybrid unit's sublayers under ``sub0`` .. ``sub7``,
stacked over units) — QAT leaves (``w``, ``pbits``) from
``lm.init_params`` or serve leaves (``w4/w2/w1/perm/pbits_sorted/wscale``,
``b``) from ``convert_tree``, or Phase-I leaves (``w``, ``s``). The port
holds one module per layer, so stacked leaves are unstacked here (into
``blocks`` and ``enc_blocks``) and stacked again on the way back
(``tree_to_numpy``). Nothing of JAX is
imported: callers hand over numpy arrays (``jax.device_get``) or a
checkpoint file.

The train state maps to the reference's (``state_to_tree`` and back,
``state_from_tree``): ``params`` (the model, groups stacked), ``opt``
(``mu`` and ``nu`` laid out as the params, None at integer leaves such as
``pbits``, and ``count``), ``step`` and, when compressing gradients,
``err`` (laid out as ``mu``); ``step`` and ``count`` int32. The
checkpoint module (``train/checkpoint.py``) and :func:`load_npz` flatten
and unflatten these trees with the reference's keys
(``params/groups/0/attn/wq/w``).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from repro_torch.core import smol
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn, lm


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):        # a bf16 leaf of a checkpoint
        return a.to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                  or a.dtype.name == "bfloat16"):
        # A bf16 leaf: two raw bytes a value (``jax.device_get``'s
        # bfloat16, or ``|V2`` from an npz), read as its bits.
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.tensor(bits, device=device).view(torch.bfloat16)
    if a.dtype.kind not in "biuf":
        raise TypeError(f"unsupported leaf dtype {a.dtype}")
    return torch.tensor(a, device=device)      # a copy: leaves may be read-only


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map(v, fn) for v in node]
    return None if node is None else fn(node)


def _group_layers(group, kind: str, count: int, cfg) -> list:
    """One plan group's (subtree, index) per port block, in block order:
    layer i of ``group``, or for a hybrid unit group sublayer i of unit u
    (``group["sub{i}"]`` at index u) as block ``u * attn_every + i``."""
    if kind != "hybrid_unit":
        return [(group, i) for i in range(count)]
    subs = range(len(cfg.hybrid_unit_kinds()))
    return [(group[f"sub{i}"], u) for u in range(count) for i in subs]


def _unstack(groups, plan, cfg, fn) -> list:
    """Stacked layer groups -> one tree a block, ``fn`` applied to every
    leaf."""
    if len(groups) != len(plan):
        raise ValueError(f"{len(groups)} layer groups for plan {plan}")
    return [_map(sub, lambda a, i=i: fn(a[i]))
            for (kind, count), group in zip(plan, groups)
            for sub, i in _group_layers(group, kind, count, cfg)]


def _port_layout(tree: Dict, cfg, fn) -> Dict:
    """A tree in the JAX package's layout (stacked ``groups``, and
    ``enc_groups`` for an encoder) -> the port's (``blocks`` and
    ``enc_blocks`` lists), ``fn`` applied to every leaf (None leaves stay
    None)."""
    out = {k: _map(v, fn) for k, v in tree.items()
           if k not in ("groups", "enc_groups")}
    out["blocks"] = _unstack(tree["groups"], cfg.layer_plan(), cfg, fn)
    if "enc_groups" in tree:
        out["enc_blocks"] = _unstack(tree["enc_groups"],
                                     (("enc", cfg.encoder_layers),), cfg, fn)
    return out


def _jax_layout(tree: Dict, cfg) -> Dict:
    """The port's layout (numpy leaves, ``blocks`` and ``enc_blocks``
    lists) -> the JAX package's (one stacked ``groups`` entry per plan
    group, a hybrid unit's sublayers under ``sub{i}``; the encoder's
    layers in one ``enc_groups`` entry)."""
    out = {k: v for k, v in tree.items()
           if k not in ("blocks", "enc_blocks")}
    groups, start = [], 0
    for kind, count in cfg.layer_plan():
        if kind == "hybrid_unit":
            n = len(cfg.hybrid_unit_kinds())
            groups.append({f"sub{i}": _stack_leaves(
                tree["blocks"][start + i:start + n * count:n])
                for i in range(n)})
            start += n * count
        else:
            groups.append(_stack_leaves(tree["blocks"][start:start + count]))
            start += count
    out["groups"] = groups
    if "enc_blocks" in tree:
        out["enc_groups"] = [_stack_leaves(tree["enc_blocks"])]
    return out


def params_from_numpy(tree: Dict, cfg, device: DeviceLike = None) -> lm.LM:
    """The JAX package's params tree (numpy leaves, stacked layer groups
    under ``groups``) -> an :class:`~repro_torch.models.lm.LM` on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return lm.LM(cfg, _port_layout(tree, cfg, lambda a: _tensor(a, dev)))


def linear_from_numpy(leaf: Dict, device: DeviceLike = None
                      ) -> smol.SmolLinear:
    """A reference linear leaf (numpy; FP, NOISE, QAT or SERVE) -> a
    ``SmolLinear`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return smol.SmolLinear(_map(leaf, lambda a: _tensor(a, dev)))


def linear_to_numpy(lin: smol.SmolLinear) -> Dict:
    """A ``SmolLinear`` (or a conv) -> its leaf with numpy host copies."""
    return _map(lin.leaf(), host_copy)


def cnn_from_numpy(tree: Dict, cfg, device: DeviceLike = None) -> cnn.CNN:
    """The reference's CNN tree (``stem``, ``stages[i][j].{dw, pw, bn_g,
    bn_b}``, ``head``; numpy leaves, any phase) -> a
    :class:`~repro_torch.models.cnn.CNN` on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    return cnn.CNN(cfg, _map(tree, lambda a: _tensor(a, dev)))


def cnn_to_numpy(model: cnn.CNN) -> Dict:
    """The port's CNN -> the reference's tree with numpy host copies."""
    return _map(model.tree(), host_copy)


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor (never a view of it: the port updates
    parameters and moments in place). bf16 keeps its two bytes a value,
    as the reference's npz holds them (``|V2``)."""
    t = t.detach()
    h = t.cpu() if t.device.type != "cpu" else t.clone()
    if h.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy().view("V2")
    return h.numpy()


def tree_to_numpy(model: lm.LM) -> Dict:
    """The port's model -> the JAX package's params layout with numpy
    leaves (one stacked ``groups`` entry per plan group)."""
    return _jax_layout(_map(model.tree(), host_copy), model.cfg)


def _stack_leaves(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in first}
    return None if first is None else np.stack(trees)


def _paths(node, prefix: str = ""):
    """The port's layout with each leaf replaced by its dotted module path
    (``blocks.0.attn.wq.w``: the parameter's name)."""
    if isinstance(node, dict):
        return {k: _paths(v, f"{prefix}{k}.") for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_paths(v, f"{prefix}{i}.") for i, v in enumerate(node)]
    return None if node is None else prefix[:-1]


def _leaves_by_path(tree: Dict, cfg) -> Dict[str, object]:
    """A JAX-layout tree -> {dotted port path: leaf} (None leaves
    dropped)."""
    flat = flatten_tree(_port_layout(tree, cfg, lambda a: a))
    return {k.replace("/", "."): v for k, v in flat.items()
            if v is not None}


def state_to_tree(state: Dict) -> Dict:
    """The port's train state -> the reference's (``repro.train.state``)
    with numpy leaves, every one a host copy."""
    model = state["model"]
    paths = _paths(model.tree())

    def laid_out(values: Dict[str, torch.Tensor]) -> Dict:
        return _jax_layout(_map(paths, lambda p: None if values.get(p) is None
                                else host_copy(values[p])), model.cfg)

    opt = state["opt"]
    out = {"params": tree_to_numpy(model),
           "opt": {"mu": laid_out(opt["mu"]), "nu": laid_out(opt["nu"]),
                   "count": np.asarray(opt["count"], np.int32)},
           "step": np.asarray(state["step"], np.int32)}
    if state.get("err") is not None:
        out["err"] = laid_out(state["err"])
    return out


def state_from_tree(tree: Dict, cfg, device: DeviceLike = None) -> Dict:
    """The reference's train state (numpy leaves, bf16 moments as torch
    tensors) -> the port's on ``device``; the model's parameters take
    gradients. ``mu``, ``nu`` and ``err`` keep their saved dtypes."""
    dev = resolve_device(device)
    model = params_from_numpy(tree["params"], cfg, dev)
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]

    def by_param(sub: Dict, what: str) -> Dict[str, torch.Tensor]:
        leaves = _leaves_by_path(sub, cfg)
        missing = [n for n in names if n not in leaves]
        if missing:
            raise ValueError(f"{what} has no leaf for {missing[:4]}")
        return {n: _tensor(leaves[n], dev) for n in names}

    opt = tree["opt"]
    state = {"model": model,
             "opt": {"mu": by_param(opt["mu"], "opt/mu"),
                     "nu": by_param(opt["nu"], "opt/nu"),
                     "count": int(np.asarray(opt["count"]))},
             "step": int(np.asarray(tree["step"]))}
    if tree.get("err") is not None:
        state["err"] = by_param(tree["err"], "err")
    return state


def cache_from_numpy(tree: Dict, cfg, device: DeviceLike = None) -> Dict:
    """The JAX package's decode cache (numpy leaves, each plan group's
    layers stacked ``[L, ...]`` under ``groups``; a hybrid unit's
    sublayers under ``sub{i}``, stacked over units) -> the port's
    ``{"layers": [...]}`` on ``device``, one a block: a layer's ``kv`` (fp
    ring, packed 4-bit ring or packed 4-bit page pool) and its ``ssm``
    state (``h`` fp32, the ``conv`` window in the cache dtype). The fp
    ring's ``pos``
    becomes int64 (the port's fp ring stamps); the paged layers share one
    page table, as the reference broadcasts one table to every layer. An
    encoder-decoder's ``cross`` K/V (fp or packed 4-bit, stacked over the
    decoder's layers) carry over as they are."""
    dev = resolve_device(device)
    plan = cfg.layer_plan()
    if len(tree["groups"]) != len(plan):
        raise ValueError(f"{len(tree['groups'])} cache groups for plan "
                         f"{plan}")
    layers = []
    table = None
    for (kind, count), group in zip(plan, tree["groups"]):
        for sub, i in _group_layers(group, kind, count, cfg):
            layer = {}
            if "ssm" in sub:
                layer["ssm"] = {name: _tensor(a[i], dev)
                                for name, a in sub["ssm"].items()}
            if "kv" in sub:
                kv = {name: _tensor(a[i], dev)
                      for name, a in sub["kv"].items()}
                if "k" in kv:
                    kv["pos"] = kv["pos"].long()
                if "page_table" in kv:
                    if table is None:
                        table = kv["page_table"]
                    elif not torch.equal(table, kv["page_table"]):
                        raise ValueError("paged layers disagree on the "
                                         "page table")
                    kv["page_table"] = table
                layer["kv"] = kv
            layers.append(layer)
    out = {"layers": layers}
    if tree.get("cross") is not None:
        out["cross"] = {name: _tensor(a, dev)
                        for name, a in tree["cross"].items()}
    return out


def cache_to_numpy(cache: Dict, cfg) -> Dict:
    """The port's decode cache -> the JAX package's layout with numpy host
    copies (the inverse of :func:`cache_from_numpy`): each plan group's
    layers stacked under ``groups`` (a hybrid unit's sublayers under
    ``sub{i}``), the fp ring's ``pos`` int32, every paged layer holding
    the shared page table, ``cross`` as it is."""
    layers = [_map(layer, host_copy) for layer in cache["layers"]]
    for layer in layers:
        kv = layer.get("kv")
        if kv is not None and "k" in kv:
            kv["pos"] = kv["pos"].astype(np.int32)
    out = {"groups": _jax_layout({"blocks": layers}, cfg)["groups"]}
    if cache.get("cross") is not None:
        out["cross"] = _map(cache["cross"], host_copy)
    return out


def flatten_tree(tree) -> Dict[str, object]:
    """{"a": {"b": [{"c": x}]}} -> {"a/b/0/c": x}: the reference's
    checkpoint keys (dict keys and list indices joined by "/"); None
    leaves are kept."""
    out: Dict[str, object] = {}

    def walk(node, key):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[key] = node
            return
        for k, v in items:
            walk(v, f"{key}/{k}" if key else str(k))

    walk(tree, "")
    return out


def unflatten_tree(flat: Dict[str, object]) -> Dict:
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
        flat = {k: z[k] for k in z.files if k.startswith("params/")}
    return params_from_numpy(unflatten_tree(flat)["params"], cfg, device)
