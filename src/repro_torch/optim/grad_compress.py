"""Int8 error-feedback gradient compression. Counterpart of
``repro.optim.grad_compress``.

Each gradient leaf, plus the error carried from the last step, is
quantized to int8 with one abs-max scale for the leaf; the residual of
that quantization is the next step's error (error feedback, Karimireddy
et al. 2019), so the compression is unbiased over time. With data
parallelism the int8 codes are what an all-reduce would move (4x fewer
bytes than fp32); on one card the step compresses and decompresses in
place of that reduction, as the reference's does under one device.

Trees are dicts keyed by parameter path (``blocks.0.attn.wq.w``); an
integer leaf (``pbits``) or a missing gradient is None and passes through.
The arithmetic is the reference's, op by op: ``scale = max(max|g + err|,
1e-12) / 127`` (a true fp32 division), codes rounded half to even and
clipped to +-127. It stays plain torch ops on the card (abs-max, divide,
round, clamp, cast, error update); the reference has no kernel here.

The reference's ``psum_compressed`` (an int8 all-reduce inside
``shard_map``) waits for the port's ``torch.distributed`` meshes.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

SCALE_EPS = 1e-12
QMAX = 127.0

Leaf = Optional[torch.Tensor]


def compress_leaf(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g + err) -> (int8 codes, fp32 scale (0-d), new error)."""
    gf = g.float() + err
    m = torch.amax(torch.abs(gf))
    scale = torch.maximum(m, m.new_tensor(SCALE_EPS)) / QMAX
    q = torch.clamp(torch.round(gf / scale), -QMAX, QMAX).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _compressible(t: Leaf) -> bool:
    return t is not None and t.is_floating_point()


def compress_tree(grads: Mapping[str, Leaf], err: Mapping[str, Leaf]
                  ) -> Tuple[Dict[str, Tuple[Leaf, Leaf]], Dict[str, Leaf]]:
    """Returns ({path: (codes, scale)}, the new error tree). A None or
    integer gradient maps to (itself, None) and keeps its error."""
    qtree, new_err = {}, dict(err)
    for path, g in grads.items():
        if not _compressible(g):
            qtree[path] = (g, None)
            continue
        q, s, e = compress_leaf(g, err[path])
        qtree[path] = (q, s)
        new_err[path] = e
    return qtree, new_err


def decompress_tree(qtree: Mapping[str, Tuple[Leaf, Leaf]]
                    ) -> Dict[str, Leaf]:
    return {path: q if s is None else decompress_leaf(q, s)
            for path, (q, s) in qtree.items()}


def init_error_tree(leaves: Mapping[str, Leaf]) -> Dict[str, Leaf]:
    """Zero fp32 errors for the floating leaves, None for the rest."""
    return {path: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            if _compressible(t) else None for path, t in leaves.items()}
