"""Port parity for the VLM family (qwen2-vl-72b, reduced: 4 layers,
d_model 128, 4 heads of 32 over 2 KV heads, d_ff 256 SwiGLU, attention and
MLP biases, an untied readout, M-RoPE sections (8, 4, 4); fp32) against the
JAX package (``xla_ref``) on numpy inputs from a seed: the config, M-RoPE's
tables, the full-sequence forward on precomputed embeddings and [3, B, S]
position streams at FP, QAT and SERVE (a 4 x 4 image whose patches share
their temporal position, and a 2112-token video-and-image prompt that takes
the chunked attention), the embeddings of table rows against the tokens
path, the engines' greedy tokens (the text path) and ``soniq.apply`` in
every phase.

The position streams are laid out as Qwen2-VL lays them out (arXiv:
2409.12191 §2.1): text runs on all three streams; a vision block of t x h x
w merged patches takes (t, h, w) offsets from the previous maximum plus 1,
and the text after it starts at that block's maximum plus 1. The vision
tower is a stub in both packages, so the patch embeddings are seeded
normals. The reference's steps and forwards are compiled as
tests/test_torch_serve.py compiles them (the activation scale's division
kept true)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import soniq as jsoniq
from repro.configs import get_config as jget_config
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve.scheduler import Request as JRequest

from repro_torch import interop, soniq
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import common as pcommon
from repro_torch.models import lm as plm
from repro_torch.serve import engine as pengine
from repro_torch.serve.scheduler import Request as PRequest

from test_torch_train import (JaxDraws, _stacked_linears, _true_division,
                              key_paths_of)
from test_torch_whisper import _compile_as_written, _serve_cfg

ARCH = "qwen2-vl-72b"
TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_batch=3, cache_len=32, prefill_chunk=4)
# Text, a 4 x 4 image (one temporal position), text: 40 tokens.
IMAGE = (("text", 8), ("vision", 1, 4, 4), ("text", 16))
# Text, a video of 4 frames of 8 x 16 patches, text, an image of 16 x 32,
# text: 2112 tokens, past the chunked attention's threshold (2048).
CHUNKED = (("text", 64), ("vision", 4, 8, 16), ("text", 64),
           ("vision", 1, 16, 32), ("text", 960))


def mrope_positions(layout) -> np.ndarray:
    """int32 [3, S] position streams (temporal, height, width) of a layout
    of ("text", n) and ("vision", t, h, w) segments."""
    parts, start = [], 0
    for seg in layout:
        if seg[0] == "text":
            p = start + np.arange(seg[1])
            parts.append(np.stack([p, p, p]))
            start += seg[1]
        else:
            t, h, w = seg[1:]
            grid = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                               indexing="ij")
            parts.append(np.stack([g.ravel() for g in grid]) + start)
            start += max(t, h, w)
    return np.concatenate(parts, axis=1).astype(np.int32)


def vision_mask(layout) -> np.ndarray:
    """bool [S]: True at a vision segment's patches."""
    return np.concatenate([np.full(seg[1] if seg[0] == "text"
                                   else int(np.prod(seg[1:])),
                                   seg[0] != "text") for seg in layout])


def layout_inputs(layout, b, d, seed):
    """(embeds fp32 [b, S, d] seeded normals at the table's scale 0.02,
    positions int32 [3, b, S])."""
    pos = mrope_positions(layout)
    emb = np.random.default_rng(seed).normal(
        0, 0.02, (b, pos.shape[1], d)).astype(np.float32)
    return emb, np.ascontiguousarray(np.broadcast_to(
        pos[:, None], (3, b, pos.shape[1])))


def _requests(cls):
    rng = np.random.default_rng(1)
    return [cls(prompt=rng.integers(1, 100, (n,)), max_new_tokens=m, seed=i)
            for i, (n, m) in enumerate(zip((3, 9, 5), (5, 4, 4)))]


def _tokens_of(eng, reqs):
    got = {c.request_id: c.tokens for c in eng.serve(reqs)}
    return {k - min(got): v for k, v in got.items()}


def _without_pbits(tree):
    """A QAT tree's FP twin: every ``pbits`` leaf dropped."""
    if isinstance(tree, dict):
        return {k: _without_pbits(v) for k, v in tree.items()
                if k != "pbits"}
    if isinstance(tree, (list, tuple)):
        return [_without_pbits(v) for v in tree]
    return tree


def _noise_tree(qat, rng):
    """A Phase-I tree of the QAT tree's weights: each linear's ``pbits``
    replaced by logits ``s`` spread over the 4/2/1-bit bands."""
    tree = jax.tree.map(np.array, qat)
    for lin in _stacked_linears(tree):
        lin["s"] = rng.normal(-0.2, 1.5, lin.pop("pbits").shape).astype(
            np.float32)
    return tree


# --------------------------------------------------------------- setup ----
@pytest.fixture(scope="module")
def bridged():
    """(JAX qat cfg (``xla_ref``), port qat cfg, the JAX QAT params, the
    port's packed model at per-token activation scales, that packing in
    the JAX layout)."""
    jcfg, pcfg = jget_config(ARCH).reduced(), pget_config(ARCH).reduced()
    jcfg = dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, backend="xla_ref"))
    qat = jax.device_get(jax.jit(lambda k: jlm.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    pscfg = _serve_cfg(pcfg)
    served = plm.LM(pscfg, ptransforms.convert_tree(
        interop.params_from_numpy(qat, pcfg, "cpu").tree(), pscfg.quant,
        rebudget=True))
    return jcfg, pcfg, qat, served, interop.tree_to_numpy(served)


@pytest.fixture(scope="module")
def jax_tokens(bridged):
    """The JAX engines' greedy tokens on the port's packing: the fp ring,
    the 4-bit ring and speculative k = 2 with its ``spec_stats``."""
    jcfg, *_rest, tree = bridged
    out = {}
    for form, kw in (("fp", {}), ("kv4", dict(kv_bits=4)),
                     ("spec", dict(spec_tokens=2))):
        eng = jengine.DecodeEngine(tree, jcfg, jengine.EngineConfig(
            backend="xla_ref", **ENGINE, **kw), already_serve=True)
        out[form] = _tokens_of(eng, _requests(JRequest))
        if form == "spec":
            out["spec_stats"] = eng.spec_stats()
    return out


# -------------------------------------------------------------- config ----
def test_config_equals_the_reference():
    want, got = jget_config(ARCH), pget_config(ARCH)
    for a, b in ((want, got), (want.reduced(), got.reduced())):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        da.pop("quant")
        db.pop("quant")
        assert da == db
    assert got.layer_plan() == want.layer_plan() == (("attn_mlp", 80),)
    assert (got.mrope_sections, got.reduced().mrope_sections) == \
        ((16, 24, 24), (8, 4, 4))
    assert (got.attn_bias, got.tie_embeddings, got.frontend) == \
        (True, False, "vision_stub")
    assert got.reduced().q_block == 64 and got.reduced().num_layers == 4


# ----------------------------------------------------------------- RoPE ----
@pytest.mark.parametrize("head_dim,sections,theta",
                         [(32, (8, 4, 4), 1e6), (128, (16, 24, 24), 1e6)])
def test_mrope_tables_match_jax(head_dim, sections, theta):
    """Distinct streams (a video block's t, h and w apart): x rotated by
    the port's tables within 1e-6 of the reference's ``apply_rope``;
    three equal streams give the [B, S] tables bitwise."""
    pos = mrope_positions(CHUNKED[:3])
    b, s = 2, pos.shape[1]
    streams = np.stack([pos, pos[::-1, ::-1]], axis=1)          # [3, 2, S]
    x = np.random.default_rng(head_dim).standard_normal(
        (b, s, 2, head_dim)).astype(np.float32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(streams), theta,
                              sections)
    cos, sin = pcommon.rope_tables(torch.tensor(streams), head_dim, theta,
                                   sections)
    got = pcommon.apply_rope_tables(torch.tensor(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    flat = torch.tensor(streams[0])
    equal = pcommon.rope_tables(flat[None].expand(3, b, s), head_dim, theta,
                                sections)
    for a, c in zip(equal, pcommon.rope_tables(flat, head_dim, theta)):
        assert torch.equal(a, c)


# -------------------------------------------------------------- forward ----
def _phase_inputs(bridged, mode, layers=None):
    """(jax cfg, jax params, port cfg, port model) of one phase: FP (the
    QAT tree without its pbits), QAT, SERVE (the port's packing, at
    per-token activation scales); FP and QAT at the first ``layers``
    layers when given."""
    jcfg, pcfg, qat, served, tree = bridged
    if mode == "serve":
        return _serve_cfg(jcfg), tree, served.cfg, served
    params = _without_pbits(qat) if mode == "fp" else qat
    jc, pc = jcfg.with_quant_mode(mode), pcfg.with_quant_mode(mode)
    if layers is not None:
        jc = dataclasses.replace(jc, num_layers=layers)
        pc = dataclasses.replace(pc, num_layers=layers)
        params = dict(params, groups=[jax.tree.map(lambda a: a[:layers],
                                                   params["groups"][0])])
    return jc, params, pc, interop.params_from_numpy(params, pc, "cpu")


@pytest.mark.parametrize("mode,layout", [
    ("fp", "image"), ("qat", "image"), ("serve", "image"),
    ("qat", "chunked")])
def test_forward_with_embeds_matches_jax(bridged, mode, layout):
    """``forward(embeds=, positions=[3, B, S])``: the hidden state and the
    logits within 1e-4 of the reference's. On the image layout the 16
    patches share one temporal position, so the causal mask (the temporal
    stream's) lets them attend each other both ways; a mask taken from
    another stream, or from 0 .. S - 1, moves their rows. The chunked
    layout (2112 tokens, query blocks of 64) runs the chunked attention
    over a video and an image, at QAT on the first 2 layers. Served, 2112 tokens meet
    the activation grid's knife edge: layer 0's ``wo`` input of row 2068
    lies 9.2e-8 of a grid step from a rounding tie, where the port's
    float64 attention sums and XLA's fp32 sums round to either side, so
    that row's codes flip and its K/V move the rows after it (the
    reference's own backends differ so too)."""
    lay, b = (IMAGE, 2) if layout == "image" else (CHUNKED, 1)
    jc, params, pc, model = _phase_inputs(
        bridged, mode, layers=None if layout == "image" else 2)
    emb, pos = layout_inputs(lay, b, pc.d_model, seed=3)

    def run(p, e, q):
        h, _ = jlm.forward(p, jc, embeds=e, positions=q)
        return h, jlm.logits(p, jc, h)

    want = _compile_as_written(run, params, emb, pos)(params, emb, pos)
    with torch.no_grad():
        hidden, aux = plm.forward(model, pc, embeds=emb, positions=pos)
        got = (hidden, plm.logits(model, pc, hidden))
    assert aux is None
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("mode", ["qat", "serve"])
def test_table_row_embeds_with_equal_streams_are_the_tokens_path(bridged,
                                                                 mode):
    """Embeddings that are the table's rows of the tokens, at three equal
    position streams, give the tokens path's logits (positions [B, S])
    bitwise."""
    _jc, _params, pc, model = _phase_inputs(bridged, mode)
    tokens = np.random.default_rng(4).integers(
        0, pc.vocab_size, (2, 12)).astype(np.int64)
    pos = np.tile(np.arange(12), (2, 1))
    emb = model.embed.table[torch.tensor(tokens)].detach()
    with torch.no_grad():
        a, _ = plm.forward(model, pc, tokens, positions=pos)
        c, _ = plm.forward(model, pc, embeds=emb,
                           positions=np.broadcast_to(pos, (3, 2, 12)))
        assert torch.equal(plm.logits(model, pc, a), plm.logits(model, pc, c))
    with pytest.raises(ValueError, match="tokens or embeds"):
        plm.forward(model, pc)


def test_params_cross_both_ways(bridged):
    """The weight bridge carries the attention and MLP biases, the untied
    ``lm_head`` and the pbits: the QAT tree and the packed tree come back
    bitwise, stacked as the reference stacks them."""
    _jcfg, pcfg, qat, served, tree = bridged
    back = interop.flatten_tree(interop.tree_to_numpy(
        interop.params_from_numpy(qat, pcfg, "cpu")))
    want = interop.flatten_tree(qat)
    assert set(back) == set(want)
    assert {"groups/0/attn/wk/b", "groups/0/mlp/down/b", "lm_head/w",
            "groups/0/mlp/gate/pbits"} <= set(back)
    for key, a in want.items():
        np.testing.assert_array_equal(back[key], np.asarray(a))
    again = interop.flatten_tree(interop.tree_to_numpy(
        interop.params_from_numpy(tree, served.cfg, "cpu")))
    for key, a in interop.flatten_tree(tree).items():
        np.testing.assert_array_equal(again[key], a)
    assert "groups/0/mlp/down/w1" in again and "lm_head/w" in again


# ------------------------------------------------------------ engines ----
ENGINE_FORMS = {"fp_ring": ("fp", {}), "kv4_ring": ("kv4", dict(kv_bits=4)),
                "kv4_paged": ("kv4", dict(kv_bits=4, kv_layout="paged",
                                          page_size=16)),
                "spec": ("spec", dict(spec_tokens=2))}


@pytest.mark.parametrize("form", sorted(ENGINE_FORMS))
def test_decode_engine_tokens_equal_jax(bridged, jax_tokens, form):
    """The text path (the reference's decode broadcasts a step's [B, S]
    positions to three equal streams, i.e. RoPE): the port's greedy tokens
    equal the JAX ``DecodeEngine``'s on the same packing over the fp ring,
    the 4-bit ring and the 4-bit pool (against the 4-bit ring), and
    speculatively at k = 2 (``rounds`` and ``drafted`` equal too)."""
    _jcfg, pcfg, _qat, served, _tree = bridged
    want_form, kw = ENGINE_FORMS[form]
    eng = pengine.DecodeEngine(served, pcfg, pengine.EngineConfig(
        **ENGINE, **kw), already_serve=True, device="cpu")
    got = _tokens_of(eng, _requests(PRequest))
    want = jax_tokens[want_form]
    assert set(got) == set(want) == {0, 1, 2}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if eng.pool is not None:
        eng.pool.check()
    if form == "spec":
        st, jst = eng.spec_stats(), jax_tokens["spec_stats"]
        assert st["rounds"] > 0 and st["drafted"] == 2 * st["rounds"]
        assert (st["rounds"], st["drafted"]) == (jst["rounds"],
                                                 jst["drafted"])


# --------------------------------------------------------------- façade ----
@pytest.mark.parametrize("phase", ["noise", "qat", "serve"])
def test_soniq_apply_with_embeds(bridged, phase):
    """``soniq.apply(state, embeds=, positions=[3, B, S])`` against the
    reference's ``soniq.apply`` on the same tree: NOISE on the reference's
    draws replayed, QAT, and SERVE after the port's ``to_serve`` (per-token
    activation scales, as the engine's): logits within 1e-4."""
    jcfg, pcfg, qat, _served, _tree = bridged
    emb, pos = layout_inputs(IMAGE, 2, pcfg.d_model, seed=5)
    key = jax.random.PRNGKey(7)
    if phase == "noise":
        tree = _noise_tree(qat, np.random.default_rng(1))
        pc = pcfg.with_quant_mode("noise")
    else:
        tree = qat
        pc = dataclasses.replace(pcfg, quant=dataclasses.replace(
            pcfg.quant, act_scale_mode="per_token"))
    state = soniq.SoniqState(pc.quant.phase,
                             interop.params_from_numpy(tree, pc, "cpu"), pc)
    if phase == "serve":
        state = soniq.to_serve(state)
        tree = interop.tree_to_numpy(state.model)
    jc = _serve_cfg(jcfg) if phase == "serve" else (
        jcfg.with_quant_mode(phase) if phase == "noise" else
        dataclasses.replace(jcfg, quant=dataclasses.replace(
            jcfg.quant, act_scale_mode="per_token")))
    jst = jsoniq.SoniqState(jsoniq.Phase.from_mode(jc.quant.mode),
                            jax.tree.map(jnp.asarray, tree), jc)
    if phase == "noise":
        with _true_division():
            want = jax.jit(lambda s, e, q: jsoniq.apply(
                s, embeds=e, positions=q, rng=key))(jst, emb, pos)
    else:
        want = _compile_as_written(lambda s, e, q: jsoniq.apply(
            s, embeds=e, positions=q), jst, emb, pos)(jst, emb, pos)
    noise = JaxDraws(key_paths_of(key, pc)) if phase == "noise" else None
    with torch.no_grad():
        got = soniq.apply(state, embeds=emb, positions=pos, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ entries ----
def test_serve_launcher_serves_qwen2_vl(capsys):
    """``--arch qwen2-vl-72b --reduced`` serves text requests as the
    reference's launcher does, here over the 4-bit page pool."""
    serve_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--requests", "3", "--prompt-len", "6",
                         "--new-tokens", "4", "--cache-len", "32",
                         "--kv-bits", "4", "--kv-layout", "paged",
                         "--page-size", "4"])
    out = capsys.readouterr().out
    assert "arch qwen2-vl-72b-reduced, 4 layers" in out
    assert out.count("[length @ step") == 3
