"""Lifecycle transforms. Counterpart of ``repro.api.transforms``.

State level (the public ``soniq`` surface):

    init / init_linear   build a SoniqState in the phase its config selects
    apply                forward pass (a single linear, the CNN or the LM)
    to_qat               Phase I -> Phase II (Problem 1 + PatternMatch +
                         precision freeze, on the host)
    to_serve             Phase II -> deployment (rebudget -> channel
                         reorder -> bit-pack)

The reference's transforms are functional: they copy the tree to the host
and return a new one. The port's change the model in place, because a
copy would double a full-width model on the card: the returned state
shares the module, and the consumed state raises on any later
``apply``, ``to_qat`` or ``to_serve``.

Tree level (the same transforms without the state, what the train loop
and the decode engine compose): the Phase I -> II boundary
(``freeze_qat``) and the deploy packing of QAT leaves into packed serve
leaves (``rebudget_pbits``, ``pack_linear``, ``pack_conv``,
``convert_linear``, ``convert_tree``).

Large tensors stay on their device; only the [.., K / 16] group arrays
(precisions, group magnitudes) visit the host, where the channel order is
decided: one copy there and one back per leaf. A linear, a conv (on its
[Cin, kh * kw * Cout] rows), or a stacked [L | E, K, N] leaf, packs in one
launch of the ``quantize_pack`` kernel (B7) on CUDA, which reads the rows
through the channel order in place.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.backend import base as backend
from repro_torch.core import patterns as patterns_lib
from repro_torch.core import quant
from repro_torch.core import schedule as schedule_lib
from repro_torch.core import smol
from repro_torch.core.phases import Phase
from repro_torch.core.qtypes import QuantConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn, lm
from .state import LinearSpec, SoniqState

average_bpp = schedule_lib.average_bpp


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
    w = torch.as_tensor(w)
    mag = _host(group_absmax(w.reshape(1, w.shape[0], -1),
                             w.shape[0] // pbits.shape[0]))
    return rebudget_pbits_host(pbits, mag[0], w.shape[0], qcfg)


def group_absmax(w: torch.Tensor, g: int) -> torch.Tensor:
    """max |w| over each group of ``g`` rows of each slice: w [S, K, N] ->
    fp32 [S, K // g], in one pass on w's device and with no temporary of
    w's size (``vector_norm`` at ord inf is the exact abs-max). The
    reduction runs in w's own dtype: an abs-max is one of its values,
    exact in any float dtype, so only the [S, K // g] result is cast."""
    s, k = w.shape[:2]
    return torch.linalg.vector_norm(w.reshape(s, k // g, -1),
                                    ord=float("inf"), dim=-1).float()


def rebudget_pbits_host(pbits: np.ndarray, mag: np.ndarray, k: int,
                        qcfg: QuantConfig) -> np.ndarray:
    """:func:`rebudget_pbits` given the group magnitudes on the host:
    ``pbits`` and ``mag`` [..., K // G] (one row a slice) -> int8 [...,
    K // G]. Within a slice, groups rank by pbits, then magnitude, both
    descending, then index."""
    pbits = np.asarray(pbits)
    mag = np.asarray(mag)
    counts = qcfg.group_pbits(k)
    n4 = int((counts == 4).sum())
    n2 = int((counts == 2).sum())
    pb2 = pbits.reshape(-1, pbits.shape[-1])
    rows, n = pb2.shape
    slice_of = np.repeat(np.arange(rows), n)
    order = np.lexsort((-mag.reshape(-1), -pb2.astype(np.int64).reshape(-1),
                        slice_of)).reshape(rows, n) % n
    rank = np.empty((rows, n), np.int64)
    np.put_along_axis(rank, order, np.arange(n)[None], axis=-1)
    out = np.where(rank < n4, 4, np.where(rank < n4 + n2, 2, 1))
    return out.astype(np.int8).reshape(pbits.shape)


def _to_host(tensors):
    """Host arrays of ``tensors``, in one device-to-host copy for each
    (device, dtype) among them."""
    groups = defaultdict(list)
    for i, t in enumerate(tensors):
        groups[(t.device, t.dtype)].append(i)
    out = [None] * len(tensors)
    for idx in groups.values():
        flat = _host(torch.cat([tensors[i].reshape(-1) for i in idx]))
        off = 0
        for i in idx:
            out[i] = flat[off:off + tensors[i].numel()].reshape(
                tuple(tensors[i].shape))
            off += tensors[i].numel()
    return out


def _to_device(arrays, devices, fn=None):
    """``arrays[i]`` on ``devices[i]``, in one host-to-device copy for each
    (device, dtype) among them: views of one buffer each, which ``fn``
    (elementwise) maps first when given."""
    groups = defaultdict(list)
    for i, (a, dev) in enumerate(zip(arrays, devices)):
        groups[(dev, a.dtype)].append(i)
    out = [None] * len(arrays)
    for (dev, _dt), idx in groups.items():
        flat = torch.as_tensor(np.concatenate(
            [arrays[i].reshape(-1) for i in idx]), device=dev)
        if fn is not None:
            flat = fn(flat)
        off = 0
        for i in idx:
            out[i] = flat[off:off + arrays[i].size].view(arrays[i].shape)
            off += arrays[i].size
    return out


def _weight_scale(mag: torch.Tensor) -> torch.Tensor:
    """Group abs-max -> group scale, as ``quant.per_group_weight_scale``."""
    return quant.div_const(torch.clamp_min(mag, quant.ACT_SCALE_EPS),
                           quant.static_grid_max(4))


def _carriers(jobs):
    """The (w4, w2, w1) carriers of each job, views of one allocation for
    each device (each carrier 16-byte aligned in it)."""
    shapes = [[j["w"].shape[:1] + (kp * p // 8, j["w"].shape[-1])
               for p, kp in zip((4, 2, 1), j["segs"])] for j in jobs]
    sizes = [[-(-int(np.prod(shape)) // 16) * 16 for shape in job]
             for job in shapes]
    by_device = defaultdict(list)
    for i, j in enumerate(jobs):
        by_device[j["w"].device].append(i)
    out = [None] * len(jobs)
    for dev, idx in by_device.items():
        buf = torch.empty(sum(sum(sizes[i]) for i in idx), dtype=torch.uint8,
                          device=dev)
        parts = iter(torch.split(buf, [x for i in idx for x in sizes[i]]))
        for i in idx:
            out[i] = [next(parts)[:int(np.prod(shape))].view(shape)
                      for shape in shapes[i]]
    return out


@torch.no_grad()
def _pack_leaves(leaves, qcfg: QuantConfig):
    """Rebudget (optional) + pack QAT leaves [(w, pbits, b, rebudget)],
    each w [K, N] or stacked [..., K, N] (its slices share one [K4|K2|K1]
    split), into serve leaves. Large tensors stay on their device, and the
    host work is done for all leaves at once:
      - each leaf's group abs-max is one pass on its device;
      - the magnitudes and precisions come to the host in one copy, where
        the channel order of every slice of the same K is decided at once
        (rebudget, stable sort 4 -> 2 -> 1, channel perm);
      - the perms, sorted precisions and sorted magnitudes go back in one
        copy, the group scales are computed there for all leaves at once
        (``per_group_weight_scale`` of a group-permuted weight is the
        group-permuted scale);
      - each leaf is one B7 launch that reads its rows through the perm and
        writes its carriers, stacked for a stacked leaf."""
    scaled = qcfg.scale_mode != "none"
    jobs = []
    for w, pbits, b, rebudget in leaves:
        w = torch.as_tensor(w)
        lead, (k, n) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
        g = qcfg.eff_group_size(k)
        pb = torch.as_tensor(pbits)
        if tuple(pb.shape) != lead + (k // g,):
            raise ValueError(f"pbits {tuple(pb.shape)} do not cover w "
                             f"{tuple(w.shape)} in groups of {g}")
        w3 = w.reshape((-1, k, n))
        jobs.append(dict(w=w3, lead=lead, k=k, g=g, b=b, rebudget=rebudget,
                         pb=pb.reshape(w3.shape[0], -1),
                         mag=group_absmax(w3, g) if rebudget or scaled
                         else None))
    host = iter(_to_host([j["pb"] for j in jobs] + [
        j["mag"] for j in jobs if j["mag"] is not None]))
    for j in jobs:
        j["pb"] = next(host)
    for j in jobs:
        j["mag"] = None if j["mag"] is None else next(host)
    groups = defaultdict(list)
    for j in jobs:
        groups[(j["k"], j["g"], j["rebudget"])].append(j)
    for (k, g, rebudget), group in groups.items():
        pb = np.concatenate([j["pb"] for j in group])
        mag = None if group[0]["mag"] is None else \
            np.concatenate([j["mag"] for j in group])
        if rebudget:
            pb = rebudget_pbits_host(pb, mag, k, qcfg)
        gperm = patterns_lib.reorder_channels(pb)
        pb_sorted = np.take_along_axis(pb, gperm, -1)
        perm = patterns_lib.expand_group_perm(gperm, g).astype(np.int32)
        smag = np.take_along_axis(mag, gperm, -1) if scaled else None
        off = 0
        for j in group:
            rows = slice(off, off + len(j["pb"]))
            off = rows.stop
            j["pb_sorted"] = pb_sorted[rows].astype(pb.dtype if rebudget
                                                    else j["pb"].dtype)
            j["perm"] = perm[rows]
            j["smag"] = None if smag is None else smag[rows]
            j["segs"] = [int((pb_sorted[rows.start] == p).sum()) * g
                         for p in (4, 2, 1)]
    devices = [j["w"].device for j in jobs]
    perms = _to_device([j["perm"] for j in jobs], devices)
    pbits_sorted = _to_device([j["pb_sorted"] for j in jobs], devices)
    scales = _to_device([j["smag"] for j in jobs], devices, _weight_scale) \
        if scaled else [None] * len(jobs)
    out = []
    for j, perm, pb_sorted, sc, carriers in zip(
            jobs, perms, pbits_sorted, scales, _carriers(jobs)):
        packed = backend.quantize_pack_mixed(j["w"], j["pb_sorted"], sc,
                                             j["g"], perm=perm, out=carriers)
        lead = j["lead"]
        leaf = {name: packed[name].reshape(lead + packed[name].shape[1:])
                for name in ("w4", "w2", "w1")}
        leaf["perm"] = perm.reshape(lead + (j["k"],))
        leaf["pbits_sorted"] = pb_sorted.reshape(lead + (-1,))
        leaf["wscale"] = None if sc is None else sc.reshape(lead + (-1,))
        if j["b"] is not None:
            leaf["b"] = torch.as_tensor(j["b"])
        out.append(leaf)
    return out


@torch.no_grad()
def pack_linear(leaf: Dict, qcfg: QuantConfig) -> Dict:
    """One trained [K, N] linear (w, pbits) -> channel-reordered packed
    carriers + metadata (a serve leaf)."""
    return _pack_leaves([(leaf["w"], leaf["pbits"], leaf.get("b"), False)],
                        qcfg)[0]


def convert_linear(leaf: Dict, qcfg: QuantConfig, *,
                   rebudget: bool = True) -> Dict:
    """Rebudget (optional) + pack one [K, N] linear leaf."""
    return _pack_leaves([(leaf["w"], leaf["pbits"], leaf.get("b"),
                          rebudget)], qcfg)[0]


def _conv_leaf(leaf: Dict, shape) -> Dict:
    """A packed [Cin, kh * kw * Cout] leaf -> the conv's serve leaf:
    carriers [rows, kh, kw, Cout] (rows given explicitly: a segment may
    have none)."""
    kh, kw, _cin, cout = shape
    for name in ("w4", "w2", "w1"):
        leaf[name] = leaf[name].reshape(leaf[name].shape[0], kh, kw, cout)
    return leaf


@torch.no_grad()
def pack_conv(leaf: Dict, qcfg: QuantConfig) -> Dict:
    """One trained conv [kh, kw, Cin, Cout] (w, pbits), quantized along
    Cin, -> its serve leaf: the [Cin, kh * kw * Cout] rows packed as a
    linear (one B7 launch), carriers [rows, kh, kw, Cout]."""
    w = torch.as_tensor(leaf["w"])
    packed = _pack_leaves([(cnn.conv_rows(w), leaf["pbits"], leaf.get("b"),
                            False)], qcfg)[0]
    return _conv_leaf(packed, tuple(w.shape))


def _is_qat_leaf(node) -> bool:
    return isinstance(node, dict) and "w" in node and "pbits" in node


@torch.no_grad()
def convert_tree(tree, qcfg: QuantConfig, *, rebudget="auto"):
    """QAT tree (nested dicts/lists of tensors) -> serve tree. Every leaf
    packs in one launch, a leaf with leading stacked dims ([L, K, N],
    [E, K, N]) too; stacked slices are rebudgeted unless
    ``rebudget=False``, since they must share packed shapes; a 2-D linear
    and a conv ([kh, kw, Cin, Cout] with 1-D pbits) only when
    ``rebudget is True``. The host work of all leaves is batched
    (``_pack_leaves``)."""
    if rebudget not in (True, False, "auto"):
        raise ValueError(f"rebudget={rebudget!r}")
    leaves, conv_shapes = [], []

    def collect(node):
        if _is_qat_leaf(node):
            w = torch.as_tensor(node["w"])
            pb = torch.as_tensor(node["pbits"])
            if w.dim() == 4 and pb.dim() == 1:      # conv [kh, kw, Cin, Cout]
                conv_shapes.append(tuple(w.shape))
                w = cnn.conv_rows(w)
            elif w.dim() < 2 or pb.dim() != w.dim() - 1:
                raise ValueError(f"pbits {tuple(pb.shape)} do not fit w "
                                 f"{tuple(w.shape)}")
            else:
                conv_shapes.append(None)
            reb = rebudget is True if w.dim() == 2 else \
                rebudget in (True, "auto")
            leaves.append((w, node["pbits"], node.get("b"), reb))
        elif isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)

    collect(tree)
    packed = iter(zip(_pack_leaves(leaves, qcfg), conv_shapes))

    def fix(node):
        if _is_qat_leaf(node):
            leaf, shape = next(packed)
            return leaf if shape is None else _conv_leaf(leaf, shape)
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fix(v) for v in node)
        return node

    return fix(tree)


def tree_map_layers(fn, tree):
    """Map ``fn`` over every dict node of a tree of tensors (returning a
    new dict stops the recursion into that node): the layer-walking
    primitive of the tree-level transforms."""
    if isinstance(tree, dict):
        new = fn(tree)
        if new is not tree:
            return new
        return {k: tree_map_layers(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_layers(fn, v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# The state level.
# ---------------------------------------------------------------------------

def with_phase(cfg, phase):
    """Copy of a QuantConfig, ArchConfig, CNNConfig or LinearSpec in the
    given lifecycle phase (a string or a Phase object)."""
    phase = Phase.from_mode(phase)
    if isinstance(cfg, QuantConfig):
        return cfg.with_mode(phase)
    if hasattr(cfg, "with_quant_mode"):      # ArchConfig
        return cfg.with_quant_mode(phase)
    return dataclasses.replace(cfg, quant=cfg.quant.with_mode(phase))


def init(model_cfg, qcfg: Optional[QuantConfig] = None, *, seed: int = 0,
         device: DeviceLike = None) -> SoniqState:
    """A :class:`SoniqState` in the phase its quant config selects, with
    random weights from the port's generator seeded with ``seed`` on
    ``device`` (default: the card). ``model_cfg`` is an ``ArchConfig``
    (LM), a ``CNNConfig`` or a :class:`LinearSpec`; ``qcfg`` (optional)
    replaces its quant field. The parameters take gradients in the
    trainable phases."""
    if qcfg is not None:
        model_cfg = dataclasses.replace(model_cfg, quant=qcfg)
    phase = model_cfg.quant.phase
    if phase is Phase.SERVE:
        raise ValueError("a serve state comes from to_serve of a trained "
                         "QAT state")
    if isinstance(model_cfg, LinearSpec):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = smol.SmolLinear(smol.linear_init(
            model_cfg.k, model_cfg.n, model_cfg.quant, generator=gen,
            device=dev, use_bias=model_cfg.use_bias))
    elif isinstance(model_cfg, cnn.CNNConfig):
        model = cnn.cnn_init(model_cfg, seed=seed, device=device)
    else:
        model = lm.init_params(model_cfg, seed=seed, device=device)
    model.requires_grad_(phase.trainable)
    return SoniqState(phase, model, model_cfg)


def init_linear(k: int, n: int, qcfg: QuantConfig, *, seed: int = 0,
                use_bias: bool = False,
                device: DeviceLike = None) -> SoniqState:
    """Single-SmolLinear state (quickstart, unit tests)."""
    return init(LinearSpec(k=k, n=n, use_bias=use_bias, quant=qcfg),
                seed=seed, device=device)


def _device(model: nn.Module) -> torch.device:
    return next(itertools.chain(model.parameters(), model.buffers())).device


def apply(state: SoniqState, x=None, *, noise=None, **inputs):
    """Forward pass of a state in its phase.

    * LinearSpec: ``apply(state, x)`` -> [..., N]
    * CNNConfig:  ``apply(state, images)`` (NHWC) -> logits [B, classes]
    * ArchConfig: ``apply(state, tokens)`` (or ``tokens=`` or ``embeds=``
      [B, S, D], the VLM's patch and text embeddings, and ``positions=``
      [B, S] or M-RoPE's [3, B, S]; an encoder-decoder also ``frames=``
      [B, T, frontend_dim]) -> fp32 logits [B, S, V]

    Phase I needs ``noise``: a ``smol.NoiseSource`` (e.g. one replaying
    other draws) or a key (an int or a tuple of ints) of a
    ``smol.StepNoise``."""
    state.check_live("apply")
    cfg = state.forward_cfg
    qcfg = cfg.quant
    if noise is not None and not hasattr(noise, "draw"):
        noise = smol.StepNoise(noise, qcfg.quantize_activations)
    if state.phase is Phase.NOISE and noise is None:
        raise ValueError(f"apply in {Phase.NOISE!r} needs noise draws")
    model = state.model
    if isinstance(state.model_cfg, LinearSpec):
        return model(torch.as_tensor(x, device=_device(model)), qcfg, noise)
    if isinstance(state.model_cfg, cnn.CNNConfig):
        return cnn.cnn_apply(model, x, cfg, noise)
    other = set(inputs) - {"tokens", "embeds", "positions", "frames"}
    if other:
        raise TypeError(f"apply got unknown inputs {sorted(other)}")
    hidden, _ = lm.forward(model, cfg, inputs.get("tokens", x),
                           embeds=inputs.get("embeds"),
                           positions=inputs.get("positions"),
                           frames=inputs.get("frames"), noise=noise)
    return lm.logits(model, cfg, hidden)


def _spend(state: SoniqState, by: str, phase) -> SoniqState:
    """The state of ``state``'s module in ``phase``; ``state`` is spent."""
    state.consumed_by = (by, phase)
    return SoniqState(phase, state.model, state.model_cfg)


def to_qat(state: SoniqState) -> Tuple[SoniqState, Dict]:
    """Phase I -> Phase II boundary: freeze the trained ``s`` into
    per-group ``pbits`` (Problem-1 solve + PatternMatch, on the host), in
    place. Returns (the QAT state, sharing the module; the pattern
    report). ``state`` is consumed."""
    state.check_live("to_qat")
    if state.phase is not Phase.NOISE:
        raise ValueError(f"to_qat expects {Phase.NOISE!r}, got "
                         f"{state.phase!r}")
    _, report = freeze_qat(state.model, state.qcfg)
    return _spend(state, "to_qat", Phase.QAT), report


def to_serve(state: SoniqState, *, rebudget="auto") -> SoniqState:
    """Phase II -> deployment, in place: every quantized leaf is
    rebudgeted (where packed shapes must be shared), channel-reordered
    (paper Obs. 4) and bit-packed, one B7 launch a leaf; its module then
    holds the serve leaf. ``rebudget``: True (always), False (never) or
    "auto" (the leaves the reference stacks: an LM's block linears, which
    it holds [L, K, N]). Returns the serve state, sharing the module;
    ``state`` is consumed."""
    state.check_live("to_serve")
    if state.phase is not Phase.QAT:
        raise ValueError(f"to_serve expects {Phase.QAT!r}, got "
                         f"{state.phase!r}")
    model = state.model
    if rebudget == "auto" and isinstance(model, lm.LM):
        rebudget = True
    lins = [lin for _path, lin in smol.smol_linears(model)
            if "pbits" in lin._names]
    packed = convert_tree([lin.leaf() for lin in lins],
                          state.model_cfg.quant, rebudget=rebudget)
    for lin, leaf in zip(lins, packed):
        lin.set_leaf(leaf)
    model.requires_grad_(False)
    return _spend(state, "to_serve", Phase.SERVE)
