"""Top-level language model: init, the full-sequence forward and the
training loss, the decode cache, decode, chunked-prefill and speculative
verify steps, and the serving capabilities of a family. Counterpart of
``repro.models.lm``. The encoder-decoder (whisper) adds the encoder
(``encode``: the stub frontend, one fp projection of mel frames, fixed
sinusoids and the ``enc`` blocks) and the decoder's cross K/V
(``build_cross_cache``, the cache's ``cross`` subtree), and adds
sinusoids to the decoder's embeddings in every step. The VLM (qwen2-vl)
takes its patch and text embeddings precomputed (``forward(embeds=)``,
the vision tower a stub as in the reference) and M-RoPE's [3, B, S]
position streams in the full-sequence forward; its serve steps take
[B, S] positions, which M-RoPE reduces to RoPE. The hybrid (jamba) lists
each unit's ``attn_every`` sublayers as blocks of their own
(:func:`block_kinds`): block ``u * attn_every + i`` is the reference's
``groups[0]["sub{i}"]`` of unit u, so every loop over blocks and cache
layers walks the sublayers, and only the attention sublayer holds K/V.

The model state is an :class:`LM` module; its ``tree()`` is the nested
dict of tensors the transforms and the weight bridge speak (per-layer
``blocks`` list, where the JAX package stacks layers ``[L, ...]``). Steps
update the cache (KV: fp or 4-bit, ring or page pool; the SSM's recurrent
state) in place and return it with the logits. The training forward
recomputes each block in its backward (``torch.utils.checkpoint``) unless
``cfg.remat == "none"``, as the reference remats every layer; the Phase-I
draws are keyed by the linear's path, so the recomputation sees the same
noise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import smol
from repro_torch.core.numerics import row_block_matmul
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve import kv_quant
from . import attention, blocks
from .common import (Embed, embed_logits, embed_lookup, norm_init,
                     norm_module, rope_tables, sinusoid_at,
                     sinusoid_positions)

LOSS_CHUNK = 1024
Z_LOSS = 1e-4
MOE_AUX = 0.01           # weight of the MoE load-balancing loss
ENC_LEN = 1500           # the reference's default encoder length (30 s)


class LM(nn.Module):
    """The LM: embed, blocks, final norm, readout; for an encoder-decoder
    also the frontend projection, the encoder blocks and their final
    norm."""

    def __init__(self, cfg, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(tree["embed"])
        self.final_norm = norm_module(tree["final_norm"])
        self.lm_head = None if cfg.tie_embeddings else \
            smol.SmolLinear(tree["lm_head"])
        kinds = block_kinds(cfg)
        if len(kinds) != len(tree["blocks"]):
            raise ValueError(f"{len(tree['blocks'])} blocks for a plan of "
                             f"{len(kinds)} layers")
        self.blocks = nn.ModuleList(
            blocks.Block(kind, bt, act=cfg.mlp_act)
            for kind, bt in zip(kinds, tree["blocks"]))
        self.frontend = self.enc_blocks = self.enc_norm = None
        if cfg.encoder_layers:
            if len(tree["enc_blocks"]) != cfg.encoder_layers:
                raise ValueError(f"{len(tree['enc_blocks'])} encoder blocks "
                                 f"for {cfg.encoder_layers} layers")
            self.frontend = smol.SmolLinear(tree["frontend"])
            self.enc_blocks = nn.ModuleList(
                blocks.Block("enc", bt, act=cfg.mlp_act)
                for bt in tree["enc_blocks"])
            self.enc_norm = norm_module(tree["enc_norm"])
        for name, lin in smol.smol_linears(self):
            lin.path = name

    def tree(self) -> Dict:
        out = {"embed": self.embed.tree(),
               "final_norm": self.final_norm.tree(),
               "blocks": [b.tree() for b in self.blocks]}
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head.leaf()
        if self.enc_blocks is not None:
            out["enc_blocks"] = [b.tree() for b in self.enc_blocks]
            out["enc_norm"] = self.enc_norm.tree()
            out["frontend"] = self.frontend.leaf()
        return out

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def block_kinds(cfg) -> list:
    """The kind of every block of the plan, in order: a hybrid unit
    expands into its sublayers' kinds (``cfg.hybrid_unit_kinds()``)."""
    out = []
    for kind, count in cfg.layer_plan():
        sub = cfg.hybrid_unit_kinds() if kind == "hybrid_unit" else (kind,)
        out.extend(sub * count)
    return out


def init_params(cfg, *, seed: int = 0, device: DeviceLike = None) -> LM:
    """Random model in the phase ``cfg.quant.mode`` selects (NOISE to
    start training, QAT for serving: the engine packs it), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qcfg = cfg.quant
    dt = getattr(torch, cfg.param_dtype)
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=dev) * 0.02
    tree: Dict = {"embed": {"table": table.to(dt)},
                  "final_norm": norm_init(cfg, device=dev)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = smol.linear_init(
            cfg.d_model, cfg.vocab_size, qcfg, generator=gen, device=dev,
            quantized=False, dtype=dt)
    tree["blocks"] = [blocks.block_init(kind, cfg, qcfg, generator=gen,
                                        device=dev)
                      for kind in block_kinds(cfg)]
    if cfg.encoder_layers:
        tree["enc_blocks"] = [blocks.block_init("enc", cfg, qcfg,
                                                generator=gen, device=dev)
                              for _ in range(cfg.encoder_layers)]
        tree["enc_norm"] = norm_init(cfg, device=dev)
        tree["frontend"] = smol.linear_init(
            cfg.frontend_dim, cfg.d_model, qcfg, generator=gen, device=dev,
            quantized=False, dtype=dt)
    return LM(cfg, tree)


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *,
               device: DeviceLike = None, kv_bits: Optional[int] = None,
               kv_layout: str = "ring", page_size: int = 16,
               num_pages: Optional[int] = None, enc_len: int = 0) -> Dict:
    """Decode cache, ``{"layers": [{"kv": {...}}]}`` with one dict per
    block (a Mamba2 mixer's holds ``{"ssm": {"h", "conv"}}`` instead: the
    KV options do not apply to it; in a hybrid, only the attention
    sublayers hold K/V). ``kv_bits=None`` keeps fp rings in
    ``dtype``; 4 selects the packed 4-bit family (``serve/kv_quant.py``,
    attention through kernel B4). ``kv_layout="paged"`` swaps the
    per-slot rings for a page pool per layer (``serve/kv_pool.py``;
    kernel B5 at 4 bits, the fp ring's plain attention over the gathered
    pages at fp): ``num_pages`` pages of ``page_size`` tokens shared by
    the slots through one page table that every layer reads. The paged
    layout needs the engine's ``PagePool`` to drive allocation.

    An encoder-decoder's cache also holds ``cross``: every decoder
    layer's cross K/V stacked ``[L, B, T, ...]`` as the reference lays it
    out (T = ``enc_len``, default ``ENC_LEN``), zeros until
    ``build_cross_cache`` fills it (all entries attended: zero K/V give a
    zero attention output, never NaN): fp ``k``/``v`` in ``dtype`` and
    ``pos``, or at ``kv_bits=4`` the packed family (codes, fp16 scales,
    ``pos``), whatever the self-attention's layout. ``pos`` is
    bookkeeping; cross attention reads every entry."""
    dev = resolve_device(device)
    layers = []
    table = None
    for kind in block_kinds(cfg):
        layers.append(blocks.block_cache_init(
            kind, cfg, batch, cache_len, dtype, device=dev,
            kv_bits=kv_bits, kv_layout=kv_layout, page_size=page_size,
            num_pages=num_pages, page_table=table))
        table = layers[-1].get("kv", {}).get("page_table", table)
    cache: Dict = {"layers": layers}
    if cfg.encoder_layers:
        t = enc_len or ENC_LEN
        shape = (cfg.num_layers, batch, t, cfg.num_kv_heads, cfg.hd)
        if kv_bits is not None:
            cross = kv_quant.init_qkv_cache(
                cfg.num_layers * batch, t, cfg.num_kv_heads, cfg.hd,
                device=dev)
            cross = {name: leaf.reshape((cfg.num_layers, batch)
                                        + leaf.shape[1:])
                     for name, leaf in cross.items()}
        else:
            cross = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev),
                     "pos": torch.zeros(shape[:3], dtype=torch.int32,
                                        device=dev)}
        cache["cross"] = cross
    return cache


@torch.no_grad()
def build_cross_cache(model: LM, cfg, enc_out, *,
                      kv_bits: Optional[int] = None) -> Dict:
    """Every decoder layer's cross K/V of the encoder output ``enc_out``
    [B, T, D]: the cross attention's ``wk``/``wv`` projections stacked
    [L, B, T, Hk, D] (one segment-GEMM launch each a layer in serving),
    with ``pos`` [L, B, T] = 0 .. T - 1. ``kv_bits=4`` quantizes the
    stacked projections to the packed 4-bit family
    (``kv_quant.quantize_kv``: codes and fp16 scales, the self-attention
    ring's carriers), once a request batch. Match it to the cache's
    ``kv_bits``."""
    if kv_bits not in (None, 4):
        raise ValueError(f"kv_bits must be None or 4, got {kv_bits}")
    qcfg = cfg.quant
    x = _device_tensor(enc_out, model.device)
    b, t, _ = x.shape
    dec = [blk for blk in model.blocks if blk.kind == "dec"]
    ks = torch.stack([blk.cross.wk(x, qcfg).reshape(
        b, t, cfg.num_kv_heads, cfg.hd) for blk in dec])
    vs = torch.stack([blk.cross.wv(x, qcfg).reshape(
        b, t, cfg.num_kv_heads, cfg.hd) for blk in dec])
    pos = torch.arange(t, dtype=torch.int32, device=x.device)[
        None, None].expand(len(dec), b, t).contiguous()
    if kv_bits == 4:
        kc, ksc = kv_quant.quantize_kv(ks)
        del ks
        vc, vsc = kv_quant.quantize_kv(vs)
        return {"k_codes": kc, "v_codes": vc, "k_scale": ksc,
                "v_scale": vsc, "pos": pos}
    return {"k": ks, "v": vs, "pos": pos}


def cross_kv_of(cache: Dict, layer: int) -> Optional[Dict]:
    """Decoder layer ``layer``'s slice of the cache's cross K/V (views of
    the stacked leaves), or None for a cache without them."""
    cross = cache.get("cross")
    if cross is None:
        return None
    return {name: leaf[layer] for name, leaf in cross.items()}


def has_attention(cfg) -> bool:
    """Whether the plan holds an attention layer (a KV write index, and
    RoPE tables where the family takes them, are built only then)."""
    return any(blocks.mixer_of(kind) == "attn" for kind in block_kinds(cfg))


def _rope(cfg, positions: torch.Tensor):
    """The step's shared RoPE tables (of [B, S] positions, or of the VLM's
    [3, B, S] M-RoPE streams), or None where no layer takes them."""
    if has_attention(cfg) and blocks.uses_rope(cfg):
        return rope_tables(positions, cfg.hd, cfg.rope_theta,
                           cfg.mrope_sections)
    return None


def logits(model: LM, cfg, h: torch.Tensor) -> torch.Tensor:
    """h [..., D] -> fp32 logits [..., V]. Serving takes the product in
    fixed row blocks (``core.numerics.row_block_matmul``), so a row's
    logits do not depend on how many rows the step reads out."""
    if cfg.tie_embeddings:
        if cfg.quant.mode == "serve":
            return row_block_matmul(h, model.embed.table.float().t())
        return embed_logits(model.embed.table, h)
    return smol.linear_apply(model.lm_head.leaf(), h.float(), cfg.quant)


# ------------------------------------------------------------- training ----
def _recompute(cfg) -> bool:
    return cfg.remat != "none" and torch.is_grad_enabled()


def _run_blocks(stack, x, positions, cfg, noise, rope, cross_x=None):
    """x through every block of ``stack`` (each recomputed in the backward
    when training asks for it); returns (x, the summed MoE loss or
    None)."""
    aux = None
    for block in stack:
        if _recompute(cfg):
            x, a = checkpoint(blocks.block_apply, block, x, positions, cfg,
                              cfg.quant, noise, rope=rope, cross_x=cross_x,
                              use_reentrant=False)
        else:
            x, a = blocks.block_apply(block, x, positions, cfg, cfg.quant,
                                      noise, rope=rope, cross_x=cross_x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def encode(model: LM, cfg, frames,
           noise: Optional[smol.NoiseSource] = None) -> torch.Tensor:
    """The encoder: frames [B, T, frontend_dim] -> [B, T, D] in the
    compute dtype. The stub frontend (one fp projection, as the reference
    stubs Whisper's conv stem), fixed sinusoids, the bidirectional ``enc``
    blocks, the encoder's final norm."""
    if model.enc_blocks is None:
        raise ValueError(f"{cfg.name} has no encoder")
    dev = model.device
    dt = getattr(torch, cfg.dtype)
    x = model.frontend(_device_tensor(frames, dev).to(dt), cfg.quant,
                       noise)
    b, t = x.shape[:2]
    x = x + sinusoid_positions(t, cfg.d_model).to(dev).to(dt)[None]
    positions = torch.arange(t, device=dev)[None].expand(b, t)
    x, _ = _run_blocks(model.enc_blocks, x, positions, cfg, noise, None)
    return model.enc_norm(x, cfg.norm_eps)


def forward(model: LM, cfg, tokens=None, *, embeds=None, positions=None,
            frames=None, noise: Optional[smol.NoiseSource] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence forward: tokens [B, S], or precomputed embeddings
    ``embeds`` [B, S, D] (the VLM's patch and text embeddings, cast to the
    compute dtype in place of the table lookup) -> (the hidden state after
    the final norm [B, S, D], the MoE load-balancing loss summed over the
    blocks, None for a model without MoE blocks). ``positions`` [B, S]
    (default 0 .. S - 1), or the VLM's [3, B, S] M-RoPE streams. The loss
    applies the readout in chunks. ``noise`` supplies the Phase-I draws
    (``cfg.quant.mode == "noise"``). An encoder-decoder needs ``frames``
    [B, T, frontend_dim]: the decoder attends their encoding, and its
    embeddings take the sinusoids of positions 0 .. S - 1."""
    dev = model.device
    dt = getattr(torch, cfg.dtype)
    if embeds is not None:
        x = _device_tensor(embeds, dev).to(dt)
    elif tokens is not None:
        x = embed_lookup(model.embed.table,
                         torch.as_tensor(tokens, device=dev).long(), dt)
    else:
        raise ValueError("forward needs tokens or embeds")
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=dev)[None].expand(b, s)
    positions = _device_tensor(positions, dev).long()
    cross_x = None
    if cfg.encoder_layers:
        if frames is None:
            raise ValueError("an encoder-decoder arch needs frames")
        cross_x = encode(model, cfg, frames, noise)
        x = x + sinusoid_positions(s, cfg.d_model).to(dev).to(dt)[None]
    x, aux = _run_blocks(model.blocks, x, positions, cfg, noise,
                         _rope(cfg, positions), cross_x)
    return model.final_norm(x, cfg.norm_eps), aux


def _chunk_loss(model: LM, cfg, h: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    lg = logits(model, cfg, h)                          # [B, c, V] fp32
    mask = (y >= 0).float()
    yc = torch.clamp(y, min=0)
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, yc[..., None])[..., 0]
    ce = torch.sum((logz - ll) * mask)
    zl = torch.sum(torch.square(logz) * mask)
    return ce + Z_LOSS * zl, torch.sum(mask)


def lm_loss(model: LM, cfg, hidden: torch.Tensor, labels,
            chunk: int = LOSS_CHUNK) -> torch.Tensor:
    """Softmax cross-entropy plus the z-loss over the vocabulary, in
    sequence chunks (each recomputed in the backward, so the [B, S, V]
    logits are never all resident). Labels < 0 are masked out."""
    y = torch.as_tensor(labels, device=hidden.device).long()
    s = hidden.shape[1]
    c = chunk if s % chunk == 0 else math.gcd(s, chunk)
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for i in range(s // c):
        h, yi = hidden[:, i * c:(i + 1) * c], y[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            part, n = checkpoint(_chunk_loss, model, cfg, h, yi,
                                 use_reentrant=False)
        else:
            part, n = _chunk_loss(model, cfg, h, yi)
        tot = tot + part
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(model: LM, batch: Dict, cfg,
            noise: Optional[smol.NoiseSource] = None):
    """Scalar training loss: CE + z-loss + ``MOE_AUX`` * the MoE
    load-balancing loss + (Phase I) the SONIQ bit regularizer lambda *
    ||log2(1 + e^-s)||_1. The batch holds ``tokens`` or ``embeds``,
    ``labels``, and optionally ``positions`` and ``frames``. Returns
    (loss, metrics); ``moe_aux`` is 0 for a model without MoE blocks."""
    hidden, aux = forward(model, cfg, batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          positions=batch.get("positions"),
                          frames=batch.get("frames"), noise=noise)
    loss = lm_loss(model, cfg, hidden, batch["labels"])
    if aux is not None:
        loss = loss + MOE_AUX * aux
    else:
        aux = torch.zeros((), device=loss.device)
    if cfg.quant.mode == "noise":
        loss = loss + cfg.quant.lam * smol.bit_penalty_of_params(
            model).to(loss.device)
    return loss, {"ce": loss, "moe_aux": aux.detach()}


def _decode_core(model: LM, cfg, cache: Dict, x: torch.Tensor,
                 pos) -> torch.Tensor:
    """Run x [B, S, D] at host positions ``pos`` [B, S] through every
    block, updating the cache in place. A masked lane (pos < 0) writes no
    KV and, in a chunked step (S > 1), leaves a mamba layer's state as it
    is; a one-token step advances every row's recurrent state, as the
    reference's does. Returns the hidden state before the final norm."""
    pos_host = np.asarray(pos, np.int64)
    posb = torch.as_tensor(pos_host, device=x.device)
    write = None
    rope = _rope(cfg, posb)
    if has_attention(cfg):
        kv = next(layer["kv"] for layer in cache["layers"] if "kv" in layer)
        write = attention.cache_write_index(kv, pos_host, x.device)
    for i, (block, layer_cache) in enumerate(zip(model.blocks,
                                                 cache["layers"])):
        x = blocks.block_decode(block, x, layer_cache, posb, cfg, cfg.quant,
                                rope=rope, write=write,
                                cross_kv=cross_kv_of(cache, i))
    return x


def _embed_step(model: LM, cfg, tokens, pos) -> torch.Tensor:
    """The embeddings of a step's tokens [B, C] at host positions ``pos``
    [B, C] in the compute dtype; an encoder-decoder adds the sinusoids of
    the positions (of -1 too at a masked lane: finite, never read)."""
    dev = model.device
    dt = getattr(torch, cfg.dtype)
    tok = torch.as_tensor(_host_array(tokens), dtype=torch.int64,
                          device=dev)
    x = embed_lookup(model.embed.table, tok, dt)
    if cfg.encoder_layers:
        p = torch.as_tensor(np.asarray(pos, np.int64), device=dev)
        x = x + sinusoid_at(p, cfg.d_model).to(dt)
    return x


def _device_tensor(a, device) -> torch.Tensor:
    """A tensor on ``device``: moved there, or a copy of a host array (which
    may be read-only, as a JAX array's host view is)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.tensor(np.asarray(a), device=device)


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def decode_step(model: LM, cfg, cache: Dict, tokens, pos, *, active=None):
    """One decode step. tokens [B], pos [B] (host arrays or tensors);
    ``active`` [B] bool marks live slots (others get position -1: no KV
    write, logits ignored; their recurrent state advances, garbage that
    admission wipes). Returns (fp32 logits [B, V], cache)."""
    pos = _host_array(pos).astype(np.int64)
    if active is not None:
        pos = np.where(_host_array(active), pos, -1)
    x = _embed_step(model, cfg, _host_array(tokens)[:, None], pos[:, None])
    x = _decode_core(model, cfg, cache, x, pos[:, None])
    x = model.final_norm(x[:, 0], cfg.norm_eps)
    return logits(model, cfg, x), cache


def prefill_step(model: LM, cfg, cache: Dict, tokens, pos, last_idx):
    """Chunked prefill: tokens [B, C], pos [B, C] (-1 = padding lane),
    last_idx [B] the lane of each slot's last real token. Returns (fp32
    logits [B, V] of each slot's last token, cache)."""
    dev = model.device
    pos = _host_array(pos)
    x = _embed_step(model, cfg, tokens, pos)
    x = _decode_core(model, cfg, cache, x, pos)
    last = torch.as_tensor(_host_array(last_idx), dtype=torch.int64,
                           device=dev)
    h = x[torch.arange(x.shape[0], device=dev), last]
    h = model.final_norm(h, cfg.norm_eps)
    return logits(model, cfg, h), cache


def verify_step(model: LM, cfg, cache: Dict, tokens, pos):
    """Speculative verify: the cache writes of :func:`prefill_step`
    (tokens [B, C], pos [B, C], -1 = padding lane), but fp32 logits of
    every lane, [B, C, V]: lane j scores the token after lane j's input.
    Prefill-phase slots riding the same call read their last real lane."""
    pos = _host_array(pos)
    x = _embed_step(model, cfg, tokens, pos)
    x = _decode_core(model, cfg, cache, x, pos)
    x = model.final_norm(x, cfg.norm_eps)
    return logits(model, cfg, x), cache


@dataclasses.dataclass(frozen=True)
class ServeCaps:
    """Serving capabilities of a family (``DecodeEngine`` reads them).
    ``chunkable``: steps may feed C > 1 tokens a slot. ``spec_capable``:
    speculative rounds are supported. ``state``: "kv" (attention only),
    "ssm" or "hybrid"; recurrent state needs the snapshot/recommit
    flavour of speculation (the engine's ``_spec_step``). ``note``: why a
    capability is off, for the engine's error."""
    family: str
    chunkable: bool = True
    spec_capable: bool = True
    state: str = "kv"
    note: str = ""


def serve_capabilities(cfg) -> ServeCaps:
    """The capability descriptor of an arch config, as the reference
    derives it from the layer plan: every family is chunkable and
    spec-capable; recurrent state (the SSM and the hybrid) takes the
    snapshot/recommit flavour of speculation."""
    kinds = [kind for kind, _ in cfg.layer_plan()]
    has_ssm = any("mamba" in k or k.startswith("hybrid") for k in kinds)
    has_attn = bool(cfg.encoder_layers) or any(
        "attn" in k or k in ("dec", "enc") or k.startswith("hybrid")
        for k in kinds)
    state = "kv" if not has_ssm else ("hybrid" if has_attn else "ssm")
    return ServeCaps(family=cfg.family, state=state)


# The recurrent-state leaves of a decode cache (``ssm.init_ssm_cache``).
# Unlike ring or paged K/V, whose rejected speculative writes roll back by
# position stamps or page release, they accumulate and cannot be
# un-written, so the engine snapshots them around speculative rounds.
SEQ_STATE_LEAVES = frozenset({"h", "conv"})


def _walk_state(tree, fn, name=""):
    if isinstance(tree, dict):
        return {k: _walk_state(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk_state(v, fn, name) for v in tree]
    if tree is None or name not in SEQ_STATE_LEAVES:
        return None
    return fn(tree)


def extract_seq_state(cache: Dict):
    """A snapshot of the cache's recurrent-state (``h``/``conv``) leaves: a
    tree mirroring ``cache`` with copies of those leaves and None
    everywhere else (a copy, as the steps write the cache in place)."""
    return _walk_state(cache, lambda t: t.clone())


def restore_seq_state(cache: Dict, snap) -> Dict:
    """Write an :func:`extract_seq_state` snapshot back into ``cache`` in
    place (the snapshot stays valid for another restore); every other leaf
    is left as it is."""
    def walk(c, s):
        if isinstance(c, dict):
            for k, v in c.items():
                walk(v, s[k])
        elif isinstance(c, (list, tuple)):
            for v, sv in zip(c, s):
                walk(v, sv)
        elif s is not None:
            c.copy_(s)
    walk(cache, snap)
    return cache


def seq_state_bytes(cache: Dict) -> int:
    """Bytes of the cache's recurrent-state leaves (0 without any)."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()
    _walk_state(cache, add)
    return total


def reset_cache_slots(cache: Dict, slots) -> Dict:
    """Wipe the cache rows of the given batch slots in place: fp K/V and
    4-bit codes/scales to 0, ``pos`` to -1 (entries read as empty), the
    recurrent state (``h``, ``conv``) to 0. A paged layer's pool is shared
    state owned by the host allocator: only the slots' page-table rows
    become -1 (every logical page unmapped); ``PagePool.release`` and
    ``kv_pool.apply_step_ops`` recycle pages. The encoder-decoder's
    ``cross`` K/V are left as they are: loaded once for the batch
    (``DecodeEngine.load_cross``), not state a step writes."""
    for layer in cache["layers"]:
        if "ssm" in layer:
            st = layer["ssm"]
            idx = torch.as_tensor(np.asarray(slots, np.int64),
                                  device=st["h"].device)
            for leaf in st.values():
                leaf[idx] = 0
        if "kv" not in layer:
            continue
        kv = layer["kv"]
        if "page_table" in kv:
            idx = torch.as_tensor(np.asarray(slots, np.int64),
                                  device=kv["pos"].device)
            kv["page_table"][idx] = -1
        else:
            kv_quant.reset_slots(kv, slots)
    return cache
