"""The shared serve-mode linear driver. Counterpart of
``repro.backend.base`` (the ``packed_matmul`` and ``quantize_pack_mixed``
template methods).

There is no backend registry in the port yet: the driver picks the kernel
by the device of its tensors. CUDA tensors launch the hand-written kernels
of ``repro_torch.kernels``; CPU tensors run their plain versions.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import pack as pack_lib
from repro_torch.core import quant
from repro_torch.core.qtypes import GROUP_SIZE
from repro_torch.kernels import packed_matmul as pm
from repro_torch.kernels import quant_pack as qp

ACT_SCALE_EPS = quant.ACT_SCALE_EPS

TWO_PASS_SLICE = ("the two-pass activation-quant form (plain segment GEMM "
                  "B3 + fake_quant B8) has no CUDA kernel yet; it is a "
                  "later port slice — serve with fuse_act_quant=True")


def act_scale(x: torch.Tensor, act_scale_mode: str,
              eps: float = ACT_SCALE_EPS) -> torch.Tensor:
    """Dynamic activation scale: ``per_token`` reduces over the last dim
    (row-independent), ``per_tensor`` over the whole tensor, ``none`` is
    1. The abs-max is clamped at ``eps`` (all-zero rows stay finite)."""
    if act_scale_mode == "none":
        return torch.ones((), dtype=torch.float32, device=x.device)
    if act_scale_mode == "per_token":
        return quant.abs_max_scale(x, dim=-1, eps=eps)
    return quant.abs_max_scale(x, eps=eps)


def packed_matmul(serve_params: Dict, x: torch.Tensor, qcfg) -> torch.Tensor:
    """Serve-mode SmolLinear over a packed leaf, in the reference's order:
    channel perm; per-token scale on the permuted row; the self-scale gate
    (per_token mode and one segment spanning K); one GEMM per non-empty
    [K4|K2|K1] segment accumulated in fp32; bias; cast to x's dtype."""
    bufs = {name: serve_params[name] for name, _p, _v in pack_lib.SEGMENTS}
    k = sum(bufs[name].shape[0] * v for name, _p, v in pack_lib.SEGMENTS)
    g = qcfg.eff_group_size(k)
    segs = list(pack_lib.iter_packed_segments(bufs, g))
    x = x.index_select(-1, serve_params["perm"])
    on_cpu = x.device.type == "cpu"
    fused = self_scale = False
    sx = None
    if qcfg.quantize_activations:
        fused = qcfg.fuse_act_quant
        self_scale = (fused and qcfg.act_scale_mode == "per_token"
                      and len(segs) == 1 and segs[0][3] == k)
        if not self_scale:
            sx = act_scale(x, qcfg.act_scale_mode)
        if not fused:
            if not on_cpu:
                raise NotImplementedError(TWO_PASS_SLICE)
            pbits = serve_params.get("pbits_sorted")
            if pbits is None:
                pbits = torch.as_tensor(np.concatenate(
                    [np.full(ng, p, np.float32)
                     for _n, p, _o, _kp, _go, ng in segs]))
            x = quant.fake_quant_fwd(x, pbits.float(), sx, g)
    elif not on_cpu:
        raise NotImplementedError(TWO_PASS_SLICE)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if fused and not self_scale:
        # One [M, 1] scale operand for every segment kernel (per_tensor /
        # "none" broadcast one value to each row).
        sx2 = torch.broadcast_to(sx.float().reshape(-1, 1),
                                 (m, 1)).contiguous()
    wscale = serve_params.get("wscale")
    n = max(bufs[name].shape[1] for name, _p, _v in pack_lib.SEGMENTS)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for name, p, off, kp, goff, ng in segs:
        seg_scales = None if wscale is None else wscale[goff:goff + ng]
        xs = x2[:, off:off + kp]
        if self_scale:
            pm.fused_act_selfscale_matmul(xs, bufs[name], seg_scales, p=p,
                                          group_size=g, out=y)
        elif fused:
            pm.fused_act_segment_matmul(xs, sx2, bufs[name], seg_scales,
                                        p=p, group_size=g, out=y)
        else:
            y += pm.segment_matmul_plain(xs, bufs[name], seg_scales, p=p,
                                         group_size=g)
    b = serve_params.get("b")
    if b is not None:
        y = y + b.float()
    return y.reshape(lead + (n,)).to(x.dtype)


def quantize_pack_mixed(w: torch.Tensor, pbits: np.ndarray,
                        scales: Optional[torch.Tensor] = None,
                        group_size: int = GROUP_SIZE) -> Dict:
    """Quantize + bit-pack each uniform-precision segment of a [K, N]
    weight whose sorted per-group ``pbits`` define the [K4|K2|K1] split,
    through the ``quantize_pack`` kernel."""
    w = w.float().contiguous()
    k, n = w.shape
    pbits = np.asarray(pbits)
    if pbits.ndim != 1 or pbits.shape[0] * group_size != k:
        raise ValueError(f"pbits {pbits.shape} do not cover K={k} in "
                         f"groups of {group_size}")
    ranks = np.array([{4: 0, 2: 1, 1: 2}[int(p)] for p in pbits])
    if np.any(np.diff(ranks) < 0):
        raise ValueError("pbits must be sorted 4 -> 2 -> 1")
    segs = tuple(int((pbits == p).sum()) * group_size for p in (4, 2, 1))
    if scales is not None:
        scales = scales.float().contiguous()
    out = {"segments": segs, "scales": scales, "n": n,
           "group_size": group_size}
    off = goff = 0
    for (name, p, _vpb), kp in zip(pack_lib.SEGMENTS, segs):
        if kp == 0:
            out[name] = torch.zeros((0, n), dtype=torch.uint8,
                                    device=w.device)
            continue
        ng = max(kp // group_size, 1)
        seg_scales = None if scales is None else scales[goff:goff + ng]
        out[name] = qp.quantize_pack(w[off:off + kp], seg_scales, p=p,
                                     group_size=group_size)
        off += kp
        goff += ng
    return out
