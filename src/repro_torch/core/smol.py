"""SmolLinear — the quantized linear primitive. Counterpart of
``repro.core.smol``. A linear leaf is a dict of tensors; the mode of the
``QuantConfig`` picks the forward rule:

  FP     {"w" [K, N], "b"?}               y = x @ W
  NOISE  {"w", "s" [K // G], "b"?}        Phase I:
         y = (x + sx sigma(s) eps) @ (sw clip(W / sw + sigma(s) eps', +-(2 - sigma)))
  QAT    {"w", "pbits" [K // G], "b"?}    Phase II: y = fq(x; p, sx) @ fq(W; p, sw)
  SERVE  {"w4", "w2", "w1" uint8, "perm", "pbits_sorted", "wscale", "b"?}
                                          y = q(x) @ unpack(W)

Under ``QuantConfig.prequantized`` (the hoisted training step) the QAT
rule reads each linear's weight from the step's prequantized copy
(:func:`prequantize_tree`, installed by :func:`hoisted_weights`) instead
of quantizing ``w`` again, so a microbatch's forward and its recompute
launch B8 on activations only.

The weight perturbation is kernel B9 (``backend.noise_inject``), the two
fake quantizations kernel B8 (``backend.fake_quant``), each with its
backward in plain torch; the large products stay ``torch.matmul`` in fp32
(the reference leaves them to XLA). :class:`SmolLinear` holds one leaf:
``w``, ``s`` and ``b`` as ``nn.Parameter``s (frozen until training asks
for gradients: ``train.state.init_state``), the integer leaves and the
packed carriers as buffers.

A stacked expert bank (leaves [E, ...]: w [E, K, N], s or pbits
[E, K // G]) runs the same rules on x [E, C, K], each expert with its own
seed, logits or precisions, weight scales and activation scale, as the
reference's ``vmap`` of ``linear_apply`` over the bank; the kernels take
the whole bank in one launch.

The reference draws Phase I's noise from ``jax.random``. The port takes an
explicit :class:`NoiseDraw` per linear call instead, from a source keyed
by the linear's module path (:class:`StepNoise`: a seeded
``torch.Generator`` on the device), so a recomputed block (activation
checkpointing) sees the same draws and a test can replay the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Dict, Iterator, Optional, Protocol

import numpy as np
import torch
from torch import nn

from repro_torch.backend import base as backend
from . import noise as noise_lib
from . import quant
from .numerics import row_block_matmul
from .qtypes import QuantConfig


@dataclasses.dataclass
class NoiseDraw:
    """One Phase-I linear call's randomness: the uint32 seed of the weight
    noise (a one-element int64 tensor on the device, read by kernel B9;
    a bank's E seeds, one an expert) and the activation noise ``act_eps``
    ~ U(-1, 1) of x's shape (a bank's [E, C, K], capacity rows included)."""

    seed: torch.Tensor
    act_eps: Optional[torch.Tensor] = None


class NoiseSource(Protocol):
    def draw(self, path: str, x: torch.Tensor,
             experts: Optional[int] = None) -> NoiseDraw: ...


class StepNoise:
    """The draws of one step: a ``torch.Generator`` on x's device, seeded
    from (``key``, the linear's module path), draws the weight seed and
    then the activation noise. The same (key, path) always gives the same
    draws, on the card without a host sync. ``key`` is an int or a tuple
    of ints (e.g. (seed, step, microbatch))."""

    def __init__(self, key, quantize_activations: bool = True):
        self.key = key
        self.quantize_activations = quantize_activations

    def generator_seed(self, path: str) -> int:
        digest = hashlib.blake2b(f"{self.key}/{path}".encode(),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "little") >> 1

    def draw(self, path: str, x: torch.Tensor,
             experts: Optional[int] = None) -> NoiseDraw:
        """The draws of the linear at ``path`` on input x; a bank of
        ``experts`` gets one weight seed an expert."""
        gen = torch.Generator(device=x.device)
        gen.manual_seed(self.generator_seed(path))
        seed = torch.randint(0, 1 << 32, (experts or 1,), generator=gen,
                             device=x.device, dtype=torch.int64)
        eps = None
        if self.quantize_activations:
            u = torch.rand(x.shape, generator=gen, device=x.device)
            eps = (u * 2.0 - 1.0).to(x.dtype)
        return NoiseDraw(seed=seed, act_eps=eps)


def linear_init(k: int, n: int, qcfg: QuantConfig, *,
                generator: torch.Generator, device: torch.device,
                use_bias: bool = False, dtype=torch.float32,
                quantized: bool = True, scale: float = 1.0) -> Dict:
    """Random FP, NOISE or QAT leaf (``quantized=False`` for skip layers).
    The weights come from the port's own seeded generator, not JAX's
    RNG."""
    std = scale / np.sqrt(k)
    w = torch.randn((k, n), generator=generator, device=device,
                    dtype=torch.float32) * std
    leaf: Dict = {"w": w.to(dtype)}
    if use_bias:
        leaf["b"] = torch.zeros((n,), dtype=dtype, device=device)
    if not quantized or qcfg.mode == "fp":
        return leaf
    if qcfg.mode == "noise":
        leaf["s"] = noise_lib.init_s(qcfg.num_groups(k), qcfg.p_init,
                                     device=device)
        return leaf
    if qcfg.mode == "qat":
        leaf["pbits"] = torch.as_tensor(qcfg.group_pbits(k), device=device)
        return leaf
    raise ValueError("serve leaves are made by packing trained ones "
                     "(repro_torch.api.transforms.pack_linear)")


def _matmul(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32-accumulated product cast back to x's dtype, then the bias."""
    y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _weight_scales(w: torch.Tensor, qcfg: QuantConfig,
                   group_size: int) -> torch.Tensor:
    """Per-group weight scale [K // G], a bank's [E, K // G] (a data
    statistic: no gradient)."""
    with torch.no_grad():
        if qcfg.scale_mode == "none":
            return torch.ones(tuple(w.shape[:-2]) + (
                qcfg.num_groups(w.shape[-2]),), dtype=torch.float32,
                device=w.device)
        return quant.per_group_weight_scale(w, group_size)


def _act_scale(x: torch.Tensor, qcfg: QuantConfig,
               bank: bool = False) -> torch.Tensor:
    """The activation scale; a bank's ``per_tensor`` scale is each
    expert's own over its whole [C, K] slice ([E, 1, 1]), empty capacity
    rows included, as the reference's ``vmap`` reduces it."""
    with torch.no_grad():
        if bank and qcfg.act_scale_mode == "per_tensor":
            return quant.abs_max_scale(x, dim=tuple(range(1, x.dim())))
        return backend.act_scale(x, qcfg.act_scale_mode)


def _quantize_weight(w: torch.Tensor, pbits: torch.Tensor,
                     qcfg: QuantConfig, group_size: int) -> torch.Tensor:
    """fake-quant W [K, N] along K with per-group precisions (kernel B8,
    clipped-STE backward)."""
    sw = _weight_scales(w, qcfg, group_size)
    return backend.fake_quant_weight(w, pbits, sw, group_size)


def _quantize_act(x: torch.Tensor, pbits: torch.Tensor, qcfg: QuantConfig,
                  group_size: int) -> torch.Tensor:
    if not qcfg.quantize_activations:
        return x
    bank = pbits.dim() == 2
    return backend.fake_quant(x, pbits, _act_scale(x, qcfg, bank),
                              group_size)


def _linear_noise(leaf: Dict, x: torch.Tensor, qcfg: QuantConfig,
                  noise: Optional[NoiseDraw]) -> torch.Tensor:
    if noise is None:
        raise ValueError("a Phase-I (noise) linear needs a NoiseDraw")
    w, s = leaf["w"], leaf["s"]
    k = w.shape[-2]
    g = qcfg.eff_group_size(k)
    # Group abs-max normalized to 1.0, not the grid top 1.875: the clip
    # +-(2 - sigma) must not bite below sigma ~= 1.
    sw = _weight_scales(w, qcfg, g) * float(quant.static_grid_max(4))
    sfull = quant.expand_groups(sw, k, g)[..., None]
    wn = backend.noise_inject(w.float() / sfull, s, noise.seed, g)
    wn = (wn * sfull).to(x.dtype)
    if qcfg.quantize_activations:
        x = noise_lib.inject_act_noise(x, s, noise.act_eps,
                                       _act_scale(x, qcfg, s.dim() == 2), g)
    return _matmul(x, wn, leaf.get("b"))


def _linear_qat(leaf: Dict, x: torch.Tensor,
                qcfg: QuantConfig) -> torch.Tensor:
    w = leaf["w"]
    g = qcfg.eff_group_size(w.shape[-2])
    pbits = leaf["pbits"].float()
    if qcfg.prequantized:
        wq = w.to(x.dtype)            # already on the grid (hoisted)
    else:
        wq = _quantize_weight(w, pbits, qcfg, g).to(x.dtype)
    xq = _quantize_act(x, pbits, qcfg, g)
    return _matmul(xq, wq, leaf.get("b"))


def linear_apply(leaf: Dict, x: torch.Tensor, qcfg: QuantConfig,
                 noise: Optional[NoiseDraw] = None) -> torch.Tensor:
    """x [..., K] -> [..., N] under the leaf's rule. A leaf holding only a
    plain weight (skip layer) always runs the FP rule."""
    if "w4" in leaf:
        if qcfg.mode != "serve":
            raise ValueError(f"packed leaf under mode {qcfg.mode!r}")
        return backend.packed_matmul(leaf, x, qcfg)
    quantized = "pbits" in leaf or "s" in leaf
    if quantized and qcfg.mode == "serve":
        raise ValueError(
            "serve-mode linear got an unconverted leaf (keys "
            f"{sorted(leaf)}); run repro_torch.api.transforms.convert_tree")
    if quantized and qcfg.mode in ("noise", "qat"):
        rule = "s" if qcfg.mode == "noise" else "pbits"
        if rule not in leaf:
            raise ValueError(f"{qcfg.mode}-mode linear got a leaf with keys "
                             f"{sorted(leaf)}")
        if qcfg.mode == "noise":
            return _linear_noise(leaf, x, qcfg, noise)
        return _linear_qat(leaf, x, qcfg)
    if qcfg.mode == "serve":
        # A skip layer in serving (readout, router): a row's result must
        # not depend on the number of rows in the step.
        y = row_block_matmul(x, leaf["w"]).to(x.dtype)
        b = leaf.get("b")
        return y if b is None else y + b.to(y.dtype)
    return _matmul(x, leaf["w"], leaf.get("b"))


class SmolLinear(nn.Module):
    """One linear leaf: ``w``, ``s``, ``b`` trainable, the rest buffers
    (packed carriers stay uint8). ``path`` is the module path the model
    gives it, which keys its Phase-I noise draws."""

    TRAINABLE = ("w", "s", "b")
    # Leaf order of ``linear_init``: a model restored from a JAX-layout
    # tree (sorted keys) lists its parameters as a fresh one does, so the
    # gradient norm sums in the same order after a restart.
    ORDER = ("w", "b", "s", "pbits")

    def __init__(self, leaf: Dict):
        super().__init__()
        self.path = ""
        # The step's prequantized weight under ``qcfg.prequantized``
        # (:func:`hoisted_weights`), None otherwise.
        self.hoisted: Optional[torch.Tensor] = None
        self._names = ()
        self.set_leaf(leaf)

    def set_leaf(self, leaf: Dict) -> None:
        """Hold ``leaf`` in place of the current one (the deploy packing
        swaps a QAT leaf for its serve leaf in the same module)."""
        for name in self._names:
            self._parameters.pop(name, None)
            self._buffers.pop(name, None)
        self._names = tuple(sorted(leaf, key=lambda n: (
            self.ORDER.index(n) if n in self.ORDER else len(self.ORDER))))
        for name in self._names:
            t = leaf[name]
            if name in self.TRAINABLE and t is not None \
                    and t.is_floating_point():
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))
            else:
                self.register_buffer(name, t)

    def leaf(self) -> Dict:
        return {name: getattr(self, name) for name in self._names}

    def rule_leaf(self, qcfg: QuantConfig) -> Dict:
        """The leaf the forward rule reads: under ``qcfg.prequantized`` a
        QAT leaf's ``w`` is the step's hoisted weight."""
        leaf = self.leaf()
        if qcfg.prequantized and "pbits" in leaf:
            if self.hoisted is None:
                raise ValueError(f"{self.path}: a prequantized forward "
                                 f"needs the step's hoisted weight")
            leaf["w"] = self.hoisted
        return leaf

    def forward(self, x: torch.Tensor, qcfg: QuantConfig,
                noise: Optional[NoiseSource] = None) -> torch.Tensor:
        draw = None
        if noise is not None and qcfg.mode == "noise" and "s" in self._names:
            draw = noise.draw(self.path, x)
        return linear_apply(self.rule_leaf(qcfg), x, qcfg, draw)

    def rows(self, w: torch.Tensor) -> torch.Tensor:
        """The weight as the [K, N] rows its groups run along (a conv's
        [Cin, kh * kw * Cout])."""
        return w

    def from_rows(self, w2: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`rows`."""
        return w2

    def freeze(self, pbits: torch.Tensor) -> None:
        """Phase I -> II: drop the logits ``s``, hold frozen per-group
        precisions ``pbits`` (of s's shape: a bank's [E, K // G])
        instead."""
        del self._parameters["s"]
        self.register_buffer("pbits", pbits)
        self._names = tuple("pbits" if n == "s" else n for n in self._names)


def smol_linears(model: nn.Module):
    """(module path, SmolLinear) of every linear of a model."""
    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, SmolLinear)]


def prequantize_tree(model: nn.Module, qcfg: QuantConfig,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """Fake-quantize every (w, pbits) weight of a model once, cast to
    ``compute_dtype``: {linear path: the weight on its grid}. One B8
    launch a 2-D linear and one an [E, K, N] expert bank, through the
    autograd Function, so the result is differentiable in w (the clipped
    STE) and the quantize backward runs once a step."""
    out = {}
    for path, lin in smol_linears(model):
        if "pbits" not in lin._names or "w" not in lin._names:
            continue
        w = lin.w
        g = qcfg.eff_group_size(w.shape[-2])
        out[path] = _quantize_weight(w, lin.pbits.float(), qcfg,
                                     g).to(compute_dtype)
    return out


@contextlib.contextmanager
def hoisted_weights(model: nn.Module,
                    weights: Dict[str, torch.Tensor]) -> Iterator[None]:
    """Install {linear path: prequantized weight} for forwards under
    ``qcfg.prequantized``; removed on exit. The weights are plain
    attributes, not block inputs, so a block recomputed in the backward
    reads the same tensors and quantizes no weight again."""
    mods = dict(smol_linears(model))
    try:
        for path, w in weights.items():
            mods[path].hoisted = w
        yield
    finally:
        for path in weights:
            mods[path].hoisted = None


def bit_penalty_of_params(model: nn.Module) -> torch.Tensor:
    """The Phase-I bit regularizer summed over every ``s`` of a model."""
    total = None
    for _name, lin in smol_linears(model):
        if "s" in lin._names:
            term = noise_lib.bit_penalty(lin.s)
            total = term if total is None else total + term
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total


@torch.no_grad()
def project_noise_weights(model: nn.Module, qcfg: QuantConfig) -> None:
    """The post-optimizer projection (paper Alg. 1 line 7), in place: every
    (w, s) linear's w (a bank's every expert, a conv's [Cin, kh * kw *
    Cout] rows), normalized by its group scale, is clipped to
    +-(2 - sigma(s))."""
    for _name, lin in smol_linears(model):
        if "s" not in lin._names:
            continue
        w = lin.rows(lin.w)
        k = w.shape[-2]
        g = qcfg.eff_group_size(k)
        sw = _weight_scales(w, qcfg, g)
        sfull = quant.expand_groups(sw, k, g)[..., None]
        lim = noise_lib.clip_weights(w.float() / sfull, lin.s, g)
        lin.w.copy_(lin.from_rows((lim * sfull).to(w.dtype)))
