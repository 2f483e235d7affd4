"""The paper's own model family: small CNNs (MobileNet-style blocks) with
SONIQ quantization on the pointwise convs, as the Table I / Fig. 7-9
benchmarks train them. Counterpart of ``repro.models.cnn``.

Conv weights are ``[kh, kw, Cin, Cout]`` (HWIO, the reference's layout, so
a weight carries across as a plain copy) and are quantized along Cin, the
paper's input-channel granularity. Activations are NHWC at the API; the
conv itself is ``F.conv2d`` on NCHW views (a float64 GEMM for a pointwise
conv), summed in float64, with "SAME" padding as XLA pads it (low
``total // 2``, high the rest: at stride 2 on an even size the port pads
(0, 1), not (1, 1)), as the reference computes its convs outside any
Pallas kernel. The quantized ops are the kernels' own: Phase I runs B9
on the weight's ``[Cin, kh * kw * Cout]`` rows (a view for a 1x1 conv, a
copy in that order for a kxk one, since B9's noise hashes the (row, col)
index of exactly that layout), Phase II B8 on those rows and on the
activations, serving B8 on the activations before one conv of the
dequantized carriers (in the trained channel order: see ``conv_apply``).

Batch norm uses the batch's statistics (no running stats), the mean and
population variance summed in float64, so a row's statistics do not
depend on the reduction order of the device.

The reference splits one key in 64 and hands the convs and the head one
each in call order; the port keys the draws by module path (``stem``,
``stages.<stage>.<block>.pw``, ``head``) through its ``NoiseSource``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.backend import base as backend
from repro_torch.core import noise as noise_lib
from repro_torch.core import pack as pack_lib
from repro_torch.core import quant, smol
from repro_torch.core.phases import Phase
from repro_torch.core.qtypes import QuantConfig
from repro_torch.device import DeviceLike, resolve_device

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    num_classes: int = 10
    in_channels: int = 3
    channels: Tuple[int, ...] = (16, 32)
    blocks_per_stage: int = 1
    quant: QuantConfig = dataclasses.field(
        default_factory=lambda: QuantConfig(mode="qat"))


def conv_init(kh: int, kw: int, cin: int, cout: int, qcfg: QuantConfig, *,
              generator: torch.Generator, device: torch.device,
              quantized: bool = True) -> Dict:
    """Random HWIO conv leaf from the port's generator, with ``s``
    (NOISE) or the mix's ``pbits`` (QAT) when quantized. Serve leaves come
    from packing a trained QAT leaf (``api.transforms.pack_conv``)."""
    w = torch.randn((kh, kw, cin, cout), generator=generator, device=device,
                    dtype=torch.float32) * (1.0 / np.sqrt(kh * kw * cin))
    leaf = {"w": w}
    if quantized and qcfg.mode == "noise":
        leaf["s"] = noise_lib.init_s(qcfg.num_groups(cin), qcfg.p_init,
                                     device=device)
    elif quantized and qcfg.mode == "qat":
        leaf["pbits"] = torch.as_tensor(qcfg.group_pbits(cin), device=device)
    return leaf


def conv_rows(w: torch.Tensor) -> torch.Tensor:
    """HWIO [kh, kw, Cin, Cout] -> [Cin, kh * kw * Cout] (the reference's
    ``moveaxis(w, 2, 0)``): a view for a 1x1 conv, a copy otherwise."""
    return w.permute(2, 0, 1, 3).reshape(w.shape[2], -1)


def conv_from_rows(w2: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`conv_rows` for an HWIO ``shape``."""
    kh, kw, cin, cout = shape
    return w2.reshape(cin, kh, kw, cout).permute(1, 2, 0, 3)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """x NHWC, w HWIO -> NHWC fp32, padded as XLA's "SAME". The products
    are summed in float64 and rounded to fp32 once, so an output does not
    depend on the device's reduction order: the card and the CPU agree,
    and an activation code downstream does not flip between them. A
    pointwise conv is one float64 GEMM over [B * H * W, Cin]."""
    kh, kw, cin, cout = w.shape
    if kh == kw == 1 and stride == 1 and groups == 1:
        y = x.double().reshape(-1, cin) @ w.double().reshape(cin, cout)
        return y.float().reshape(tuple(x.shape[:-1]) + (cout,))
    (t, b), (l, r) = (_same_pads(x.shape[1], kh, stride),
                      _same_pads(x.shape[2], kw, stride))
    xc = F.pad(x.double().permute(0, 3, 1, 2), (l, r, t, b))
    y = F.conv2d(xc, w.double().permute(3, 2, 0, 1), stride=stride,
                 groups=groups)
    return y.float().permute(0, 2, 3, 1)


def _act_scale(x: torch.Tensor, qcfg: QuantConfig):
    """The conv's activation scale: per tensor whatever ``act_scale_mode``
    says, unless it is "none" (the reference's ``abs_max_scale(x)``)."""
    if qcfg.act_scale_mode == "none":
        return 1.0
    with torch.no_grad():
        return quant.abs_max_scale(x)


def _serve_weight(leaf: Dict, qcfg: QuantConfig) -> torch.Tensor:
    """Packed carriers [rows, kh, kw, Cout] -> the dequantized HWIO
    kernel (fp32). A segment may have 0 rows, so each carrier is flattened
    with an explicit trailing size."""
    trailing = tuple(leaf["w4"].shape[1:])
    cin = sum(leaf[name].shape[0] * v for name, _p, v in pack_lib.SEGMENTS)
    bufs = {name: leaf[name].reshape(leaf[name].shape[0],
                                     int(np.prod(trailing)))
            for name, _p, _v in pack_lib.SEGMENTS}
    wd = pack_lib.dequant_packed_carriers(
        bufs, leaf.get("wscale"), qcfg.eff_group_size(cin))
    return conv_from_rows(wd, trailing[:2] + (cin,) + trailing[2:])


def conv_apply(leaf: Dict, x: torch.Tensor, qcfg: QuantConfig,
               noise: Optional[smol.NoiseDraw] = None, *, stride: int = 1,
               groups: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin] -> [B, H', W', Cout] under the leaf's phase; a
    leaf holding only a plain weight (``stem``, ``dw``) runs the FP rule
    in every phase."""
    if "w4" in leaf:                                # packed deployment leaf
        if groups != 1:
            raise ValueError("packed convs are pointwise or full only")
        # The dequantized rows go back to the trained channel order (row
        # perm[k] of the kernel is sorted row k), and the activations
        # quantize there with each group's precision: the reference
        # gathers x by perm instead, the same products summed in another
        # order, and a reordered sum moves an activation code at a rounding
        # edge downstream (batch norm spreads it over the batch).
        w = _serve_weight(leaf, qcfg)
        g = qcfg.eff_group_size(w.shape[2])
        perm = leaf["perm"].long()
        w = torch.empty_like(w).index_copy_(2, perm, w)
        pb = leaf["pbits_sorted"].float()
        pb = torch.empty_like(pb).index_copy_(0, perm[::g] // g, pb)
        if qcfg.quantize_activations:
            x = backend.fake_quant(x, pb, _act_scale(x, qcfg), g)
        return conv2d_same(x, w, stride)
    phase = Phase.FP if Phase.FP.owns_leaf(leaf) else qcfg.phase
    if phase is Phase.SERVE:
        raise ValueError(
            "serve-phase conv got an unconverted leaf (keys "
            f"{sorted(leaf)}); run repro_torch.api.transforms.convert_tree")
    w = leaf["w"]
    g = qcfg.eff_group_size(w.shape[2])
    if phase is Phase.NOISE:
        if noise is None:
            raise ValueError("a Phase-I (noise) conv needs a NoiseDraw")
        wf = conv_rows(w)
        with torch.no_grad():
            # Group abs-max normalized to 1.0, as the linear noise rule.
            m = wf.abs().reshape(wf.shape[0] // g, g, -1).amax(dim=(1, 2))
            sfull = quant.expand_groups(
                torch.clamp(m, min=quant.ACT_SCALE_EPS), wf.shape[0],
                g)[:, None]
        wn = backend.noise_inject(wf.float() / sfull, leaf["s"], noise.seed,
                                  g) * sfull
        w = conv_from_rows(wn, w.shape)
        if qcfg.quantize_activations and groups == 1:
            x = noise_lib.inject_act_noise(x, leaf["s"], noise.act_eps,
                                           _act_scale(x, qcfg), g)
    elif phase is Phase.QAT:
        pbits = leaf["pbits"].float()
        wf = conv_rows(w)
        sw = smol._weight_scales(wf, qcfg, g)
        w = conv_from_rows(backend.fake_quant_weight(wf, pbits, sw, g),
                           w.shape)
        if qcfg.quantize_activations and groups == 1:
            x = backend.fake_quant(x, pbits, _act_scale(x, qcfg), g)
    return conv2d_same(x, w, stride, groups)


class SmolConv(smol.SmolLinear):
    """One conv leaf (``w`` HWIO; ``s``, ``pbits`` or the packed carriers
    [rows, kh, kw, Cout]): the walkers that reach every ``SmolLinear``
    (the freeze, the bit penalty, the projection, AdamW, packing) reach it
    too, over the rows of :meth:`rows`. Its leaves list in sorted order,
    as the reference's tree does."""

    ORDER = ("b", "pbits", "s", "w")

    def __init__(self, leaf: Dict, *, stride: int = 1, groups: int = 1):
        super().__init__(leaf)
        self.stride = stride
        self.groups = groups

    def rows(self, w: torch.Tensor) -> torch.Tensor:
        return conv_rows(w)

    def from_rows(self, w2: torch.Tensor) -> torch.Tensor:
        return conv_from_rows(w2, self.w.shape)

    def forward(self, x: torch.Tensor, qcfg: QuantConfig,
                noise: Optional[smol.NoiseSource] = None) -> torch.Tensor:
        draw = None
        if noise is not None and qcfg.mode == "noise" and "s" in self._names:
            draw = noise.draw(self.path, x)
        return conv_apply(self.leaf(), x, qcfg, draw, stride=self.stride,
                          groups=self.groups)


class Block(nn.Module):
    """Depthwise 3x3 (unquantized) + pointwise 1x1 (quantized) + batch
    norm + relu. Parameters register in the reference's sorted order
    (``bn_b``, ``bn_g``, ``dw``, ``pw``)."""

    def __init__(self, tree: Dict, stride: int):
        super().__init__()
        self.bn_b = nn.Parameter(tree["bn_b"], requires_grad=False)
        self.bn_g = nn.Parameter(tree["bn_g"], requires_grad=False)
        self.dw = SmolConv(tree["dw"], stride=stride,
                           groups=tree["dw"]["w"].shape[3])
        self.pw = SmolConv(tree["pw"])

    def forward(self, h: torch.Tensor, qcfg: QuantConfig,
                noise: Optional[smol.NoiseSource]) -> torch.Tensor:
        h2 = self.pw(self.dw(h, qcfg, noise), qcfg, noise)
        x64 = h2.double()
        mu = x64.mean(dim=(0, 1, 2))
        var = torch.square(x64 - mu).mean(dim=(0, 1, 2))
        h2 = (h2 - mu.float()) * torch.rsqrt(var.float() + BN_EPS) \
            * self.bn_g + self.bn_b
        return torch.relu(h2)

    def tree(self) -> Dict:
        return {"bn_b": self.bn_b, "bn_g": self.bn_g, "dw": self.dw.leaf(),
                "pw": self.pw.leaf()}


class CNN(nn.Module):
    """stem conv, stages of blocks (stride 2 at the first block of every
    stage after the first), mean pool, linear head. Parameters register
    in the reference's sorted tree order: ``head``, ``stages``, ``stem``."""

    def __init__(self, cfg: CNNConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self.head = smol.SmolLinear(tree["head"])
        self.stages = nn.ModuleList(
            nn.ModuleList(Block(bt, 2 if bi == 0 and si > 0 else 1)
                          for bi, bt in enumerate(blocks))
            for si, blocks in enumerate(tree["stages"]))
        self.stem = SmolConv(tree["stem"])
        for name, lin in smol.smol_linears(self):
            lin.path = name

    def tree(self) -> Dict:
        return {"stem": self.stem.leaf(),
                "stages": [[b.tree() for b in blocks]
                           for blocks in self.stages],
                "head": self.head.leaf()}

    @property
    def device(self) -> torch.device:
        return self.stem.w.device


def cnn_init(cfg: CNNConfig, *, seed: int = 0,
             device: DeviceLike = None) -> CNN:
    """Random CNN in the phase ``cfg.quant`` selects, from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qcfg = cfg.quant
    kw = dict(generator=gen, device=dev)
    tree: Dict = {"stem": conv_init(3, 3, cfg.in_channels, cfg.channels[0],
                                    qcfg, quantized=False, **kw)}
    stages = []
    cin = cfg.channels[0]
    for cout in cfg.channels:
        blocks = []
        for _ in range(cfg.blocks_per_stage):
            blocks.append({
                "dw": conv_init(3, 3, 1, cin, qcfg, quantized=False, **kw),
                "pw": conv_init(1, 1, cin, cout, qcfg, **kw),
                "bn_g": torch.ones((cout,), device=dev),
                "bn_b": torch.zeros((cout,), device=dev)})
            cin = cout
        stages.append(blocks)
    tree["stages"] = stages
    tree["head"] = smol.linear_init(cin, cfg.num_classes, qcfg,
                                    quantized=False, **kw)
    return CNN(cfg, tree)


def cnn_apply(model: CNN, x, cfg: CNNConfig,
              noise: Optional[smol.NoiseSource] = None) -> torch.Tensor:
    """Images [B, H, W, C] -> fp32 logits [B, num_classes]; ``noise``
    supplies the Phase-I draws."""
    qcfg = cfg.quant
    x = torch.as_tensor(x, device=model.device)
    h = torch.relu(model.stem(x, qcfg, noise))
    for blocks in model.stages:
        for blk in blocks:
            h = blk(h, qcfg, noise)
    pooled = h.double().mean(dim=(1, 2)).float()
    return model.head(pooled, qcfg, noise)


def xent_loss(model: CNN, batch: Dict, cfg: CNNConfig,
              noise: Optional[smol.NoiseSource] = None):
    """Mean softmax cross-entropy (+ lambda * the bit regularizer in
    Phase I). Returns (loss, logits)."""
    logits = cnn_apply(model, batch["x"], cfg, noise)
    y = torch.as_tensor(batch["y"], device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y[:, None])[:, 0]
    loss = torch.mean(logz - ll)
    if cfg.quant.mode == "noise":
        loss = loss + cfg.quant.lam * smol.bit_penalty_of_params(
            model).to(loss.device)
    return loss, logits


@torch.no_grad()
def accuracy(model: CNN, x, y, cfg: CNNConfig) -> float:
    logits = cnn_apply(model, x, cfg, None)
    y = torch.as_tensor(y, device=logits.device)
    return float(torch.mean((torch.argmax(logits, -1) == y).float()))


def bits_per_param(model: nn.Module, qcfg: QuantConfig) -> float:
    """Average bits a parameter over the quantized conv and linear weights
    (the paper's Bpp), from ``pbits`` or, in Phase I, the rounded
    readout of ``s``."""
    tot_bits = tot = 0.0
    for _path, lin in smol.smol_linears(model):
        names = lin._names
        if "w" not in names or not ("pbits" in names or "s" in names):
            continue
        w = lin.w
        cin = w.shape[-2] if w.dim() == 2 else w.shape[2]
        per = w.numel() // cin
        if "pbits" in names:
            pb = lin.pbits.detach().cpu().numpy().astype(np.float64)
        else:
            s = lin.s.detach().cpu().numpy()
            pb = np.clip(np.round(1 + np.log2(1 + np.exp(-s))), 1, 8)
        g = cin // pb.shape[-1]
        tot_bits += float(pb.sum()) * g * per
        tot += w.numel()
    return tot_bits / max(tot, 1)
