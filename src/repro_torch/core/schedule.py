"""Two-phase SONIQ training orchestration (paper Alg. 3). Counterpart of
``repro.core.schedule``.

Phase I  (steps [0, t1)):  noise-injected precision search, mode "noise".
Boundary (step t1):        per-layer Problem-1 solve + PatternMatch +
                           precision freeze, on the host, in place on the
                           model ("noise" -> "qat").
Phase II (steps [t1, t2)): STE fine-tuning under the frozen precisions.
Deploy:                    packing (``api.transforms.convert_tree``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import interop
from . import patterns as patterns_lib
from . import smol
from .qtypes import QuantConfig


@dataclasses.dataclass(frozen=True)
class PhaseSchedule:
    t1: int          # Phase I steps (paper: T1 epochs)
    t2: int          # total steps   (paper: T2 epochs)

    def phase(self, step: int) -> str:
        return "noise" if step < self.t1 else "qat"


def _noise_linears(model: nn.Module) -> List[smol.SmolLinear]:
    """Every (w, s) linear (or conv) in the reference's tree order. The
    reference walks its tree with dict keys sorted and lists in order. An
    LM stacks each plan group's layers ([L, ...] leaves under
    ``groups[i]``), so there the order is: plan group, then the path
    within a block (``attn.wk``, ..., ``moe.down``, ``moe.shared.up``,
    ``moe.up``: sorted part by part), then the layer; a hybrid unit group
    nests its sublayers (``groups[i]["sub{j}"]``, each stacked over
    units), so there it is plan group, then sublayer (its key sorted as a
    string), then the path within it, then the unit; an encoder's layers
    are one stacked group (``enc_groups[0]``, sorted before the decoder's
    ``groups``) walked the same way; a linear outside the blocks sorts by
    its own path among the tree's top-level keys. Any
    other model (the CNN: ``head``, ``stages`` by stage and block,
    ``stem``) sorts by its module path, list indices as numbers."""
    cfg = getattr(model, "cfg", None)
    plan = getattr(cfg, "layer_plan", None)
    if plan is None:
        def tree_key(name):
            return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                         for p in name.split("."))
        return [lin for name, lin in sorted(
            smol.smol_linears(model), key=lambda r: tree_key(r[0]))
            if "s" in lin._names]
    # Block b's (plan group, key prefix within it, index in its stack).
    at: List[Tuple[int, Tuple[str, ...], int]] = []
    for gi, (kind, count) in enumerate(plan()):
        subs = {f"sub{i}": (f"sub{i}",)
                for i in range(len(cfg.hybrid_unit_kinds()))} \
            if kind == "hybrid_unit" else ()
        at += [(gi, prefix, i) for prefix, i in
               interop._group_layers(subs, kind, count, cfg)]
    keyed = []
    for name, lin in smol.smol_linears(model):
        if "s" not in lin._names:
            continue
        parts = name.split(".")
        if len(parts) > 2 and parts[0] == "blocks" and parts[1].isdigit():
            gi, prefix, i = at[int(parts[1])]
            key = ("groups", gi, prefix + tuple(parts[2:]), i)
        elif len(parts) > 2 and parts[0] == "enc_blocks" \
                and parts[1].isdigit():
            key = ("enc_groups", 0, tuple(parts[2:]), int(parts[1]))
        else:
            key = (parts[0], 0, tuple(parts[1:]), 0)
        keyed.append((key, lin))
    return [lin for _key, lin in sorted(keyed, key=lambda r: r[0])]


def _group_size(lin: smol.SmolLinear, qcfg: QuantConfig) -> int:
    return qcfg.eff_group_size(lin.w.shape[-2])


def _s_rows(lin: smol.SmolLinear) -> np.ndarray:
    """A linear's logits as rows [R, K // G]: one for a single weight, E
    for an expert bank (expert-minor within the layer, as the reference's
    ``s.reshape(-1, K // G)`` of its stacked [L, E, K // G] leaf reads
    them)."""
    s = lin.s.detach().cpu().numpy()
    return s.reshape(-1, s.shape[-1])


def collect_histograms(model: nn.Module, qcfg: QuantConfig
                       ) -> List[Tuple[int, int, int]]:
    """Per-(layer, expert) (N4, N2, N1) histograms from the trained s."""
    return [patterns_lib.histogram_from_s(s_row, _group_size(lin, qcfg))
            for lin in _noise_linears(model) for s_row in _s_rows(lin)]


@torch.no_grad()
def pattern_match_params(model: nn.Module, qcfg: QuantConfig
                         ) -> Tuple[nn.Module, Dict]:
    """The Phase I -> Phase II boundary, on the host, in place:

      1. select the hardware pattern subset (paper §V-A / Table III),
      2. per layer (per expert of a bank): Problem-1 solve under that
         subset, PatternMatch the s vector, freeze the per-group
         precisions,
      3. turn each (w, s) linear into a (w, pbits) QAT linear (a bank's
         pbits [E, K // G] int8).

    Returns (model, report) where the report carries the solver stats,
    one entry a row of s in the reference's order."""
    linears = _noise_linears(model)
    allowed = patterns_lib.patterns_for(qcfg.num_patterns) \
        if qcfg.num_patterns in patterns_lib.DESIGN_POINT_PATTERNS \
        else patterns_lib.select_hardware_subset(
            collect_histograms(model, qcfg), qcfg.num_patterns)
    report: Dict = {"layers": [], "allowed": allowed}
    for lin in linears:
        g = _group_size(lin, qcfg)
        pb_rows = []
        for s_row in _s_rows(lin):
            n4, n2, n1 = patterns_lib.histogram_from_s(s_row, g)
            sol = patterns_lib.solve_problem1(n4, n2, n1, allowed)
            pb = patterns_lib.precisions_from_matched_s(
                patterns_lib.pattern_match(s_row, sol, g))
            pb_rows.append(pb)
            report["layers"].append({
                "hist": (n4, n2, n1), "vectors": sol.num_vectors,
                "bpp": float((4 * (pb == 4).sum() + 2 * (pb == 2).sum()
                              + (pb == 1).sum()) / pb.size)})
        pbits = np.stack(pb_rows).reshape(lin.s.shape).astype(np.int8)
        lin.freeze(torch.as_tensor(pbits, device=lin.w.device))
    return model, report


def average_bpp(report: Dict) -> float:
    layers = report["layers"]
    return float(np.mean([l["bpp"] for l in layers])) if layers else 0.0
