"""Lifecycle transforms. Counterpart of the pytree-level transforms of
``repro.api.transforms``: the Phase I -> II boundary (``freeze_qat``) and
the deploy packing of QAT leaves into packed serve leaves
(``rebudget_pbits``, ``pack_linear``, ``convert_linear``,
``convert_tree``).

Large tensors stay on their device; only the [K / 16] group arrays
(precisions, group magnitudes) visit the host, where the channel order is
decided. Packing runs through the ``quantize_pack`` kernel (B7) on CUDA.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.backend import base as backend
from repro_torch.core import patterns as patterns_lib
from repro_torch.core import quant
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.qtypes import QuantConfig


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def freeze_qat(model: nn.Module, qcfg: QuantConfig
               ) -> Tuple[nn.Module, Dict]:
    """(noise model, qcfg) -> (the same model with QAT linears, pattern
    report): the Phase I -> II boundary (paper Alg. 3), in place."""
    return schedule_lib.pattern_match_params(model, qcfg)


def rebudget_pbits(pbits, w: torch.Tensor, qcfg: QuantConfig) -> np.ndarray:
    """Project trained per-group precisions onto the static segment budget
    (counts from ``qcfg.mix``) keeping the trained ranking; ties broken by
    group abs-max."""
    pbits = _host(pbits)
    n = pbits.shape[0]
    k = w.shape[0]
    g = k // n
    counts = qcfg.group_pbits(k)
    n4 = int((counts == 4).sum())
    n2 = int((counts == 2).sum())
    w = torch.as_tensor(w)
    mag = _host(w.float().abs().reshape(n, g, -1).amax(dim=(1, 2)))
    order = np.lexsort((-mag, -pbits.astype(np.int64)))
    out = np.empty(n, np.int8)
    out[order[:n4]] = 4
    out[order[n4:n4 + n2]] = 2
    out[order[n4 + n2:]] = 1
    return out


@torch.no_grad()
def pack_linear(leaf: Dict, qcfg: QuantConfig) -> Dict:
    """One trained [K, N] linear (w, pbits) -> channel-reordered packed
    carriers + metadata (a serve leaf)."""
    w = torch.as_tensor(leaf["w"]).float()
    pbits = _host(leaf["pbits"])
    k = w.shape[0]
    g = qcfg.eff_group_size(k)
    gperm = patterns_lib.reorder_channels(pbits)
    perm = patterns_lib.expand_group_perm(gperm, g)
    perm_t = torch.as_tensor(perm, dtype=torch.int32, device=w.device)
    w_sorted = w.index_select(0, perm_t).contiguous()
    pbits_sorted = pbits[gperm]
    scales = None if qcfg.scale_mode == "none" else \
        quant.per_group_weight_scale(w_sorted, g)
    packed = backend.quantize_pack_mixed(w_sorted, pbits_sorted, scales, g)
    out = {"w4": packed["w4"], "w2": packed["w2"], "w1": packed["w1"],
           "perm": perm_t,
           "pbits_sorted": torch.as_tensor(pbits_sorted, device=w.device),
           "wscale": scales}
    if leaf.get("b") is not None:
        out["b"] = torch.as_tensor(leaf["b"])
    return out


def convert_linear(leaf: Dict, qcfg: QuantConfig, *,
                   rebudget: bool = True) -> Dict:
    """Rebudget (optional) + pack one [K, N] linear leaf."""
    pbits = _host(leaf["pbits"])
    if rebudget:
        pbits = rebudget_pbits(pbits, torch.as_tensor(leaf["w"]), qcfg)
    return pack_linear({"w": leaf["w"], "pbits": pbits, "b": leaf.get("b")},
                       qcfg)


def _stack(leaves):
    first = leaves[0]
    return {name: None if first[name] is None
            else torch.stack([lf[name] for lf in leaves])
            for name in first}


@torch.no_grad()
def convert_tree(tree, qcfg: QuantConfig, *, rebudget="auto"):
    """QAT tree (nested dicts/lists of tensors) -> serve tree. A leaf with
    leading stacked dims ([L, K, N]) is packed per slice and re-stacked;
    stacked slices are rebudgeted unless ``rebudget=False``, since they
    must share packed shapes."""
    if rebudget not in (True, False, "auto"):
        raise ValueError(f"rebudget={rebudget!r}")

    def fix(node):
        if isinstance(node, dict) and "w" in node and "pbits" in node:
            w = torch.as_tensor(node["w"])
            if w.dim() == 2:
                return convert_linear(node, qcfg, rebudget=rebudget is True)
            if w.dim() < 2 or torch.as_tensor(node["pbits"]).dim() != \
                    w.dim() - 1:
                raise NotImplementedError(
                    "conv leaves are packed by a later port slice")
            lead = w.shape[:-2]
            flat_w = w.reshape((-1,) + tuple(w.shape[-2:]))
            flat_pb = torch.as_tensor(node["pbits"]).reshape(
                flat_w.shape[0], -1)
            b = node.get("b")
            flat_b = None if b is None else \
                torch.as_tensor(b).reshape(flat_w.shape[0], -1)
            reb = rebudget in (True, "auto")
            packed = [convert_linear(
                {"w": flat_w[i], "pbits": flat_pb[i],
                 "b": None if flat_b is None else flat_b[i]},
                qcfg, rebudget=reb) for i in range(flat_w.shape[0])]
            return {name: None if t is None
                    else t.reshape(tuple(lead) + tuple(t.shape[1:]))
                    for name, t in _stack(packed).items()}
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fix(v) for v in node)
        return node

    return fix(tree)
