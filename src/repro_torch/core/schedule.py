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
    """Every (w, s) linear in the reference's tree order: by path within a
    block (``attn.wk``, ``attn.wo``, ... sorted, as a pytree sorts dict
    keys), each over the layers in order, as the reference walks its
    stacked ``[L, ...]`` leaves."""
    by_suffix: Dict[str, List[Tuple[int, smol.SmolLinear]]] = {}
    for name, lin in smol.smol_linears(model):
        if "s" not in lin._names:
            continue
        parts = name.split(".")
        if len(parts) > 2 and parts[0] == "blocks" and parts[1].isdigit():
            key, layer = ".".join(parts[2:]), int(parts[1])
        else:
            key, layer = name, 0
        by_suffix.setdefault(key, []).append((layer, lin))
    return [lin for key in sorted(by_suffix)
            for _layer, lin in sorted(by_suffix[key], key=lambda r: r[0])]


def _group_size(lin: smol.SmolLinear, qcfg: QuantConfig) -> int:
    return qcfg.eff_group_size(lin.w.shape[0])


def collect_histograms(model: nn.Module, qcfg: QuantConfig
                       ) -> List[Tuple[int, int, int]]:
    """Per-layer (N4, N2, N1) histograms from the trained s."""
    return [patterns_lib.histogram_from_s(
        lin.s.detach().cpu().numpy(), _group_size(lin, qcfg))
        for lin in _noise_linears(model)]


@torch.no_grad()
def pattern_match_params(model: nn.Module, qcfg: QuantConfig
                         ) -> Tuple[nn.Module, Dict]:
    """The Phase I -> Phase II boundary, on the host, in place:

      1. select the hardware pattern subset (paper §V-A / Table III),
      2. per layer: Problem-1 solve under that subset, PatternMatch the s
         vector, freeze the per-group precisions,
      3. turn each (w, s) linear into a (w, pbits) QAT linear.

    Returns (model, report) where the report carries the solver stats."""
    linears = _noise_linears(model)
    allowed = patterns_lib.patterns_for(qcfg.num_patterns) \
        if qcfg.num_patterns in patterns_lib.DESIGN_POINT_PATTERNS \
        else patterns_lib.select_hardware_subset(
            collect_histograms(model, qcfg), qcfg.num_patterns)
    report: Dict = {"layers": [], "allowed": allowed}
    for lin in linears:
        s_row = lin.s.detach().cpu().numpy()
        g = _group_size(lin, qcfg)
        n4, n2, n1 = patterns_lib.histogram_from_s(s_row, g)
        sol = patterns_lib.solve_problem1(n4, n2, n1, allowed)
        pb = patterns_lib.precisions_from_matched_s(
            patterns_lib.pattern_match(s_row, sol, g))
        report["layers"].append({
            "hist": (n4, n2, n1), "vectors": sol.num_vectors,
            "bpp": float((4 * (pb == 4).sum() + 2 * (pb == 2).sum()
                          + (pb == 1).sum()) / pb.size)})
        lin.freeze(torch.as_tensor(pb.astype(np.int8), device=lin.w.device))
    return model, report


def average_bpp(report: Dict) -> float:
    layers = report["layers"]
    return float(np.mean([l["bpp"] for l in layers])) if layers else 0.0
