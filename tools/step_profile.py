"""Device time of a profiled training step: by kernel class, and the plain
ops split by the op of the port that issued each kernel; and of a profiled
load (deploy packing), split by the torch op or kernel that did the work
(``load_summary``).

    import step_profile
    undo = step_profile.install_spans()   # once repro_torch is importable
    ... run steps under torch.profiler.profile(activities=[CPU, CUDA]) ...
    summary = step_profile.device_summary(prof)   # in on_trace_ready
    undo()

An SSM training step installs ``SSM_TRAIN_SPANS`` and reads
``ssm_train_summary`` (the chunked SSD's forward and backward apart); the
encoder-decoder's encode pass and serve steps install ``WHISPER_SPANS``,
its training steps ``WHISPER_TRAIN_SPANS`` with ``whisper_train_summary``
(the float64 attention, the LayerNorms and the GELU, each forward and
backward apart).

The port carries no profiler ranges of its own. ``install_spans`` wraps a
few functions of whichever checkout of ``repro_torch`` is imported (a
function that an older checkout lacks, such as the gradient compression,
is skipped) in
``torch.profiler.record_function`` ranges, opened only while a profiler
records, so a parent and a change split the same way in one call. Each
kernel counts to the innermost range around the op that launched it. A
backward kernel counts to its autograd node: B9's and B8's custom
backward passes by the node's name, any other node to the range around
the forward op that made it (matched by the autograd sequence number and
forward thread), so a range's share covers its forward, its recompute
and its backward. What no range claims is ``rest`` (norms, attention,
the loss, the optimizer, the embedding).
"""
from __future__ import annotations

import contextlib
import functools
import importlib
from collections import defaultdict
from typing import Callable, Dict

PREFIX = "soniq::"
NODE = "autograd::engine::evaluate_function: "

# (module, attribute, label). _linear_noise and _linear_qat are the
# outermost ranges: what their inner ranges leave is the Phase-I weight
# scale chain (w / sfull, wn * sfull, the casts) and the Phase-II casts.
SPANS = (
    ("repro_torch.core.smol", "_linear_noise", "weight_scale_chain"),
    ("repro_torch.core.smol", "_linear_qat", "qat_casts"),
    ("repro_torch.core.smol", "_weight_scales", "weight_absmax"),
    ("repro_torch.core.smol", "_act_scale", "act_scale"),
    ("repro_torch.core.smol", "_matmul", "matmul"),
    ("repro_torch.core.smol", "StepNoise.draw", "noise_draw"),
    ("repro_torch.core.noise", "inject_act_noise", "act_noise"),
    ("repro_torch.backend.base", "noise_inject", "noise_inject_fwd"),
    ("repro_torch.backend.base", "fake_quant_weight", "fake_quant_fwd"),
    ("repro_torch.backend.base", "fake_quant", "fake_quant_fwd"),
    # What the MoE's banks and linears leave: the router, top-k, the
    # dispatch scatter, the combine and the load-balancing loss.
    ("repro_torch.models.moe", "moe_apply", "moe_routing"),
    # The int8 error-feedback compression of the gradients (plain ops).
    ("repro_torch.optim.grad_compress", "compress_tree", "grad_compress"),
    ("repro_torch.optim.grad_compress", "decompress_tree", "grad_compress"),
)
# A serve step of the SSM (``ssm_spans``): the mixer's plain ops, its
# chunked SSD scan, the serve linears' driver ops around B1, and the
# readout; what they leave (the embedding, the block norms, the residual
# adds) is ``rest``.
SSM_SPANS = (
    ("repro_torch.models.ssm", "mamba2_decode", "mixer"),
    ("repro_torch.models.ssm", "mamba2_prefill", "mixer"),
    ("repro_torch.models.ssm", "ssd_chunked", "ssd"),
    ("repro_torch.backend.base", "packed_matmul", "serve_linear"),
    ("repro_torch.models.lm", "logits", "readout"),
)
# The encoder-decoder's encode pass and serve steps (``WHISPER_SPANS``):
# the attention's float64 scores, softmax and value sums (``sdpa``: the
# encoder's, the decoder's fp self and cross attention), the LayerNorms,
# the GELU, the serve linears' driver ops around B1 and the readout; what
# they leave (the frontend, the sinusoids, residual adds, the 4-bit K/V
# writes) is ``rest``.
WHISPER_SPANS = (
    ("repro_torch.models.attention", "sdpa", "attention"),
    ("repro_torch.models.common", "layer_norm", "layer_norm"),
    ("repro_torch.models.common", "gelu", "gelu"),
    ("repro_torch.backend.base", "packed_matmul", "serve_linear"),
    ("repro_torch.models.lm", "logits", "readout"),
)
# The VLM's full-sequence serve forward (``soniq.apply(embeds=,
# positions=)`` on packed weights): the float64 attention (``sdpa``, in
# query blocks past 2048 positions), the RMS norms, the serve linears'
# driver ops around B1 and the untied readout in 16-row blocks; what they
# leave (M-RoPE's tables and rotation, SwiGLU, residual adds) is ``rest``.
VLM_SPANS = (
    ("repro_torch.models.attention", "sdpa", "attention"),
    ("repro_torch.models.common", "rms_norm", "rms_norm"),
    ("repro_torch.backend.base", "packed_matmul", "serve_linear"),
    ("repro_torch.models.lm", "logits", "readout"),
)
# A training step of the SSM (``ssm_train_summary``): the training spans
# and the chunked SSD scan, whose kernels count to ``ssd`` in the forward
# and the recompute and to ``ssd_bwd`` in the backward (``SPLIT_BACKWARD``),
# its float64 GEMMs included.
SSM_TRAIN_SPANS = SPANS + (("repro_torch.models.ssm", "ssd_chunked", "ssd"),)
# A training step of the encoder-decoder (``whisper_train_summary``): the
# training spans, the float64 attention (``sdpa``: scores, softmax, value
# sums of the encoder's, the decoder's self and the cross attention), the
# LayerNorms and the GELU, each counted to ``<label>`` in the forward and
# the recompute and to ``<label>_bwd`` in the backward.
WHISPER_TRAIN_SPANS = SPANS + (
    ("repro_torch.models.attention", "sdpa", "attention"),
    ("repro_torch.models.common", "layer_norm", "layer_norm"),
    ("repro_torch.models.common", "gelu", "gelu"),
)
BACKWARD_NODES = {"_NoiseInjectBackward": "noise_inject_bwd",
                  "_FakeQuantBackward": "fake_quant_bwd",
                  "_GeluBackward": "gelu_bwd"}
# Ranges whose backward nodes count apart, as ``<label>_bwd``.
SPLIT_BACKWARD = frozenset({"ssd", "attention", "layer_norm", "gelu"})


def install_spans(spans=SPANS) -> Callable[[], None]:
    """Wrap every function of ``spans`` (default ``SPANS``; ``SSM_SPANS``
    for an SSM serve step) in a profiler range named ``soniq::<label>``;
    returns the function that restores them."""
    import torch
    from torch.profiler import record_function

    def spanned(fn, name):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            on = torch.autograd._profiler_enabled()
            with record_function(name) if on else contextlib.nullcontext():
                return fn(*args, **kwargs)
        return run

    saved = []
    for module, path, label in spans:
        try:
            owner = importlib.import_module(module)
        except ModuleNotFoundError:         # an older checkout
            continue
        *outer, attr = path.split(".")
        for name in outer:                  # a method: Class.name
            owner = getattr(owner, name)
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, spanned(fn, PREFIX + label))

    def undo():
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
    return undo


def _label(event, forward_labels):
    """The label of the innermost range or autograd node above ``event``
    (None: no range claims it)."""
    e = event
    while e is not None:
        if e.name.startswith(PREFIX):
            return e.name[len(PREFIX):]
        if e.name.startswith(NODE):
            node = e.name[len(NODE):]
            if node in BACKWARD_NODES:
                return BACKWARD_NODES[node]
            label = forward_labels.get((e.fwd_thread, e.sequence_nr))
            return f"{label}_bwd" if label in SPLIT_BACKWARD else label
        e = e.cpu_parent
    return None


def forward_labels(events) -> Dict:
    """{(thread, sequence number): label} of every forward op under a
    range. A node's ``fwd_thread`` is the thread of the forward op that
    made it; a forward op's own ``fwd_thread`` is 0, so its key is its
    ``thread``."""
    out = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith(NODE):
            label = _label(e, {})
            if label is not None:
                out[(e.thread, e.sequence_nr)] = label
    return out


def kernel_split(events, kind: Callable[[str], str]) -> Dict:
    """{(label, kind(kernel name)): device ms} over the kernels of a
    profiled window that the profiler linked to the op that launched them,
    in one walk; ``rest`` labels the kernels no range claims."""
    labels = forward_labels(events)
    out: Dict = defaultdict(float)
    for e in events:
        for k in getattr(e, "kernels", ()):
            out[(_label(e, labels) or "rest", kind(k.name))] += \
                k.duration / 1e3
    return out


def op_split(events, skip: Callable[[str], bool]) -> Dict[str, float]:
    """{label: device ms} over the kernels of a profiled window, leaving
    out those whose name ``skip`` accepts (``kernel_split``)."""
    out: Dict[str, float] = defaultdict(float)
    for (label, keep), ms in kernel_split(
            events, lambda name: not skip(name)).items():
        if keep:
            out[label] += ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


FWD_KERNELS = ("noise_inject_kernel", "fake_quant_kernel")
BWD_KERNELS = ("noise_inject_bwd_kernel", "fake_quant_bwd_kernel")


def _is_gemm(name: str) -> bool:
    return "gemm" in name.lower()


def kernel_kind(name: str) -> str:
    """``gemm``, ``fwd`` (B8/B9), ``bwd`` (their backward kernels) or
    ``other`` (plain torch ops)."""
    if _is_gemm(name):
        return "gemm"
    if any(k in name for k in BWD_KERNELS):
        return "bwd"
    if any(k in name for k in FWD_KERNELS):
        return "fwd"
    return "other"


def device_summary(prof, split=None) -> Dict:
    """Device time of one profiled step by kernel: the total, the share of
    the fp32 GEMMs, of the port's B8/B9 forward kernels, of their backward
    kernels and of the rest (plain torch ops), the rest split by the op of
    the port that launched it (``split``: ``kernel_split`` by
    ``kernel_kind``, made here when not given; ``unlinked``: kernels the
    profiler tied to no op), and the top kernels. The step's own span
    annotation ("ProfilerStep*") and the ranges of ``install_spans``,
    which the profiler also lays on the device's timeline, are not
    kernels and are left out."""
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not e.key.startswith(("ProfilerStep", PREFIX))]

    def ms(keep):
        return sum(e.device_time_total for e in kern if keep(e.key)) / 1e3

    busy = ms(lambda k: True)
    gemm = ms(_is_gemm)
    fwd = ms(lambda k: kernel_kind(k) == "fwd")
    bwd = ms(lambda k: kernel_kind(k) == "bwd")
    other = busy - gemm - fwd - bwd
    if split is None:
        split = kernel_split(prof.events(), kernel_kind)
    by_op: Dict[str, float] = defaultdict(float)
    for (label, kind), t in split.items():
        if kind == "other":
            by_op[label] += t
    by_op = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
    by_op["unlinked"] = other - sum(by_op.values())
    top = sorted(kern, key=lambda e: -e.device_time_total)[:8]
    return {"kernels": sum(e.count for e in kern), "device_busy_ms": busy,
            "gemm_ms": gemm, "b8_b9_ms": fwd, "b8_b9_bwd_ms": bwd,
            "other_ms": other,
            "other_by_op": {k: round(v, 3) for k, v in by_op.items()},
            "top": [(e.key[:60], round(e.device_time_total / 1e3, 3),
                     e.count) for e in top]}


def _summary_apart(prof, labels) -> Dict:
    """``device_summary`` with each range of ``labels`` apart:
    ``<label>_ms`` (its forward and recompute) and ``<label>_bwd_ms`` (its
    backward), every kernel of theirs counted, GEMMs too; ``fp32_gemm_ms``
    the GEMMs outside them; ``rest_ms`` what is left of the busy time
    after the fp32 GEMMs, B8/B9 and their backward kernels and those
    ranges."""
    split = kernel_split(prof.events(), kernel_kind)
    out = device_summary(prof, split)
    keys = [k for label in labels for k in (label, f"{label}_bwd")]
    apart = {k: sum(t for (label, _kind), t in split.items() if label == k)
             for k in keys}
    inner_gemm = sum(t for (label, kind), t in split.items()
                     if label in apart and kind == "gemm")
    out.update({f"{k}_ms": round(t, 3) for k, t in apart.items()})
    out["fp32_gemm_ms"] = round(out["gemm_ms"] - inner_gemm, 3)
    out["rest_ms"] = round(out["device_busy_ms"] - out["fp32_gemm_ms"]
                           - out["b8_b9_ms"] - out["b8_b9_bwd_ms"]
                           - sum(apart.values()), 3)
    return out


def ssm_train_summary(prof) -> Dict:
    """``device_summary`` of a training step of the SSM profiled under
    ``SSM_TRAIN_SPANS``, with the chunked SSD apart (``ssd_ms``,
    ``ssd_bwd_ms``: its float64 GEMMs included; ``_summary_apart``)."""
    return _summary_apart(prof, ("ssd",))


def whisper_train_summary(prof) -> Dict:
    """``device_summary`` of a training step of the encoder-decoder
    profiled under ``WHISPER_TRAIN_SPANS``, with the float64 attention,
    the LayerNorms and the GELU apart, forward (with the recompute) and
    backward: ``attention_ms``, ``attention_bwd_ms`` (the float64 score
    and value GEMMs included), ``layer_norm_ms``, ``layer_norm_bwd_ms``,
    ``gelu_ms``, ``gelu_bwd_ms``; ``fp32_gemm_ms`` the linears' GEMMs and
    the readout; ``rest_ms`` the rest (``_summary_apart``)."""
    return _summary_apart(prof, ("attention", "layer_norm", "gelu"))


def device_busy(prof) -> Dict:
    """Busy ms and kernel count of a window profiled on the device alone
    (``activities=[CUDA]``: no host ops, so reading it is cheap; no split
    by op)."""
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not e.key.startswith(("ProfilerStep", PREFIX))]
    return {"kernels": sum(e.count for e in kern),
            "device_busy_ms": sum(e.device_time_total for e in kern) / 1e3}


# The load's torch ops by what they do in the packing path; a kernel
# counts to the outermost of these ops above it.
LOAD_OPS = {"aten::abs": "absmax", "aten::amax": "absmax",
            "aten::linalg_vector_norm": "absmax",
            "aten::index_select": "index_select",
            "aten::gather": "scale_chain", "aten::clamp_min": "scale_chain",
            "aten::div": "scale_chain",
            "aten::stack": "stack", "aten::cat": "stack",
            "aten::copy_": "copies", "aten::to": "copies",
            "aten::_to_copy": "copies", "aten::clone": "copies",
            "aten::contiguous": "copies"}
PACK_KERNEL = "quant_pack"


def _load_label(event) -> str:
    label = "rest"
    e = event
    while e is not None:
        label = LOAD_OPS.get(e.name, label)
        e = e.cpu_parent
    return label


def load_summary(prof) -> Dict:
    """Device time of a profiled load: busy ms, device events (kernels,
    copies, fills), and the split by op: ``absmax`` (the group magnitude
    reduction), ``index_select`` (a sorted copy of a weight),
    ``scale_chain`` (the group scales), ``quantize_pack`` (B7, by kernel
    name: a ctypes launch has no torch op above it), ``stack``
    (re-stacking carriers), ``copies`` (host-device copies and casts),
    ``rest`` (other torch ops) and ``unlinked`` (device time the profiler
    tied to no op)."""
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not e.key.startswith(("ProfilerStep", PREFIX))]
    busy = sum(e.device_time_total for e in kern) / 1e3
    out: Dict[str, float] = defaultdict(float)
    out["quantize_pack"] = sum(e.device_time_total for e in kern
                               if PACK_KERNEL in e.key) / 1e3
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            if PACK_KERNEL not in k.name:
                out[_load_label(e)] += k.duration / 1e3
    out["unlinked"] = busy - sum(out.values())
    return {"device_busy_ms": busy,
            "device_events": sum(e.count for e in kern),
            "by_op": {k: round(v, 3) for k, v in
                      sorted(out.items(), key=lambda kv: -kv[1])}}
