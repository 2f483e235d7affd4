"""Port parity for encoder-decoder training (whisper-medium, reduced: 2
encoder and 2 decoder layers, d_model 128, 4 heads of 32 over 2 KV heads,
d_ff 256 GELU, LayerNorm, attention biases, frontend_dim 16; fp32) against
the JAX package on the CPU: one ``train_step`` at NOISE and QAT with every
leaf's gradient, the recompute, ``loop.train`` through Phase I, the freeze
and Phase II, checkpoints continued in both directions, microbatches,
hoisting with compression, the trained model served after ``load_cross``,
the façade, the step profile's spans and the launcher.

Batches are the reference's ``TokenStream`` (batch 2, 16 tokens) with mel
frames [2, 24, 16] fp32 from a numpy seed; the model casts them to the
compute dtype, as the reference does. NOISE replays the reference's draws
(``JaxDraws``): the encoder scans its layers under the step key itself,
the decoder under ``fold_in(key, 0)``, each decoder block's second key to
its cross attention (``key_paths_of``). The reference's steps are jitted
with the abs-max scale divisions kept true (``_true_division``). The freeze
order of the encoder is a case of ``tests/test_torch_train.py``
(``[whisper-*]``)."""
import contextlib
import copy
import itertools
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import soniq as jsoniq
from repro.api import transforms as jtransforms
from repro.core import quant as jquant
from repro.core import schedule as jschedule
from repro.data import synthetic as jsynthetic
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.serve import engine as jengine
from repro.serve.scheduler import Request as JRequest
from repro.train import loop as jloop
from repro.train import state as jstate

from repro_torch import interop, soniq
from repro_torch.core import quant as pquant
from repro_torch.core import schedule as pschedule
from repro_torch.core import smol as psmol
from repro_torch.models import attention as pattention
from repro_torch.models import common as pcommon
from repro_torch.models import lm as plm
from repro_torch.optim import adamw as padamw
from repro_torch.serve import engine as pengine
from repro_torch.serve.scheduler import Request as PRequest
from repro_torch.train import loop as ploop
from repro_torch.train import state as pstate

from test_torch_ssm_train import _assert_continues, _step_dir, rel_l2
from test_torch_train import (LOOP_TK, WHISPER_ARCH, JaxDraws, _configs,
                              _random_s, _stacked_linears,
                              _true_division, assert_loop_train_equal,
                              key_paths_of, loop_stream, loop_train_runs,
                              microbatch_case, recompute_case, with_frames)
from test_torch_train_substrate import hoisted_case
from test_torch_whisper import _compile_as_written, _requests, _tokens_of
from test_torch_train import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
REL_L2 = 1e-5
ENGINE = dict(max_batch=3, cache_len=32, prefill_chunk=4)


def _jax_tree(jcfg):
    """The reference's initial params of ``jcfg`` (jitted: one compile,
    where the eager init compiles each op)."""
    return jax.device_get(jax.jit(lambda k: jlm.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))


def _batch(cfg, seed):
    return with_frames(next(jsynthetic.TokenStream(
        jsynthetic.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     batch_size=2, seed=seed)).batches()),
        cfg, np.random.default_rng(seed))


@contextlib.contextmanager
def _same_knife_edge():
    """Both packages' clipped-STE masks pass |x / s| up to one fp32 step
    above the grid top. The abs-max element of a per-tensor activation
    scale lands on the grid top, at 1.875 or one step above it, as its
    value rounds. The port's float64 sums and XLA's fp32 sums round a
    LayerNorm or attention output differently in the last bit now and
    then, so the two masks of that one element can disagree: the
    gradients upstream of it move by ~1e-2 and an Adam update by a step
    (ROADMAP §C; ``tools/whisper_train_vs_jax.py``). Under this rule both
    keep it; the forward is unchanged."""
    impl = jquant._fake_quant_fwd_impl

    def jax_impl(x, pbits, scale, group_size):
        y, _ = impl(x, pbits, scale, group_size)
        k = x.shape[-1]
        p = jquant._expand_groups(pbits, k, group_size).astype(jnp.float32)
        s = jnp.asarray(scale, jnp.float32)
        if s.ndim and s.shape[-1] == max(1, k // group_size) \
                and k > s.shape[-1]:
            s = jquant._expand_groups(s, k, group_size)
        xs = jnp.asarray(x, jnp.float32) / s
        top = jnp.nextafter(jquant.grid_max(p), jnp.float32(jnp.inf))
        return y, (jnp.abs(xs) <= top).astype(x.dtype)

    def port_in_range(x, pbits, scale, group_size=16):
        xs, p, _s = pquant._fake_quant_operands(x, pbits, scale, group_size)
        top = 2.0 - torch.exp2(1.0 - p)
        return (xs.abs() <= torch.nextafter(
            top, torch.tensor(float("inf")))).to(x.dtype)

    with mock.patch.object(jquant, "_fake_quant_fwd_impl", jax_impl), \
            mock.patch.object(pquant, "fake_quant_in_range", port_in_range):
        yield


def _float_leaves(tree, pcfg):
    """A JAX-layout tree of gradients -> {port parameter path: array},
    the integer leaves' (float0) gradients dropped."""
    tree = jax.tree.map(
        lambda a: np.asarray(a) if np.issubdtype(np.asarray(a).dtype,
                                                 np.floating) else None,
        jax.device_get(tree))
    return interop._leaves_by_path(tree, pcfg)


# -------------------------------------------------------- train step ----
@pytest.mark.parametrize("mode", ["noise", "qat"])
def test_train_step_gradients_equal_jax(mode):
    """One step of the reduced model from the reference's weights (NOISE:
    logits spread over the bands, the reference's draws replayed) on a
    batch with frames: the loss and the gradient norm within rtol 1e-5 of
    the reference's; every leaf's gradient within relative L2 1e-5 of
    ``jax.grad`` (the frontend, the encoder's and decoder's LayerNorm
    ``g``/``b``, ``enc_norm``, the attention biases, the cross attention,
    the embedding). A key bias's gradient is zero up to rounding (a
    constant added to every key of a row leaves its softmax unchanged), so
    it is held to 1e-5 of its attention's query-bias gradient."""
    jcfg, pcfg = _configs(arch=WHISPER_ARCH)
    jcfg, pcfg = jcfg.with_quant_mode(mode), pcfg.with_quant_mode(mode)
    tree = _jax_tree(jcfg)
    if mode == "noise":
        tree = _random_s(jax.tree.map(np.array, tree),
                         np.random.default_rng(3))
    batch = _batch(jcfg, 1)
    key = jax.random.PRNGKey(17)

    def jloss(p, b, k):
        return jlm.loss_fn(p, b, jcfg, k if mode == "noise" else None)[0]

    with _true_division():
        jl, jg = jax.jit(jax.value_and_grad(jloss, allow_int=True))(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = JaxDraws(key_paths_of(key, pcfg))
    noise = (lambda i: draws) if mode == "noise" else None
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    model.requires_grad_(True)
    loss, _ = plm.loss_fn(model, batch, pcfg,
                          draws if mode == "noise" else None)
    names, params = zip(*padamw.trainable(model))
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    pt = pstate.TrainConfig(warmup=1, t1=1 if mode == "noise" else 0, t2=4)
    st = pstate.init_state(pcfg, pt, model=interop.params_from_numpy(
        tree, pcfg, "cpu"))
    st["step"] = 1
    _, met = pstate.train_step(st, batch, pcfg, pt, noise)
    for got in (loss.item(), float(met["loss"])):
        np.testing.assert_allclose(got, float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jadamw.global_norm(jg)), rtol=1e-5)
    want = _float_leaves(jg, pcfg)
    assert set(want) == set(names)
    assert {"frontend.w", "enc_norm.g", "enc_norm.b",
            "enc_blocks.1.ln_attn.b", "blocks.0.cross.wk.w",
            "blocks.1.ln_cross.g", "enc_blocks.0.mlp.up.b"} <= set(names)
    errs = {}
    for name, g in grads.items():
        if name.endswith(".wk.b"):
            scale = np.linalg.norm(want[name.replace(".wk.b", ".wq.b")])
            errs[name] = float(np.linalg.norm(
                g.numpy().astype(np.float64) - want[name]) / scale)
        else:
            errs[name] = rel_l2(g, want[name])
    assert max(errs.values()) <= REL_L2, sorted(
        errs.items(), key=lambda kv: -kv[1])[:6]


def test_adamw_decays_the_encoder_decoder_leaves_as_jax():
    """Two AdamW steps on every leaf of the reduced model in Phase I
    against the reference's ``apply_updates`` on the same gradients:
    weight decay on ``w`` (the frontend's too) and ``table``, none on the
    LayerNorms' ``g``/``b``, the biases and ``s`` (at lr * s_lr_mult);
    every parameter within 1e-6."""
    jcfg, pcfg = _configs(arch=WHISPER_ARCH)
    rng = np.random.default_rng(5)
    # Every leaf moved off its init (zero biases would hide a decay).
    tree = jax.tree.map(lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(
        np.float32), _jax_tree(jcfg.with_quant_mode("noise")))
    model = interop.params_from_numpy(tree, pcfg.with_quant_mode("noise"),
                                      "cpu")
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    cfg = jadamw.AdamWConfig(lr=1e-2)
    upd = jax.jit(lambda t, g, st, lr: jadamw.apply_updates(
        t, g, st, cfg, lr_scale=lr))
    new, jst, _ = upd(tree, grads, jadamw.init_state(tree), 0.7)
    new, _, jm = upd(new, grads, jst, 0.5)
    pst = padamw.init_state(model)
    pgrads = {n: torch.tensor(a) for n, a in
              _float_leaves(grads, pcfg).items()}
    assert {"frontend.w", "enc_norm.b", "blocks.1.cross.wk.s"} <= set(pgrads)
    pcfg_opt = padamw.AdamWConfig(lr=1e-2)
    padamw.apply_updates(model, pgrads, pst, pcfg_opt, lr_scale=0.7)
    pm = padamw.apply_updates(model, pgrads, pst, pcfg_opt, lr_scale=0.5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    got = _float_leaves(interop.tree_to_numpy(model), pcfg)
    want = _float_leaves(new, pcfg)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_recomputed_encoder_and_decoder_blocks_see_the_same_noise():
    """The encoder's and decoder's linears draw by path
    (``enc_blocks.N.attn.wq``, ``blocks.N.cross.wk``, ...), so the
    recomputed ``enc`` and ``dec`` blocks replay the same noise: loss and
    every gradient bitwise the plain backward's."""
    recompute_case(WHISPER_ARCH)


def test_whisper_microbatches_sum_their_gradients_in_order():
    """Two microbatches split tokens, labels and frames along the batch;
    the step is bitwise AdamW on the mean of their gradients."""
    microbatch_case(WHISPER_ARCH)


def test_hoisted_whisper_step_is_the_unhoisted_step_bitwise():
    """A 2-microbatch QAT step hoisted (one B8 call a weight: 24 linears,
    the frontend fp) and unhoisted: loss, gradient norm and parameters
    bitwise, also compressed; the compression error kept for every leaf by
    path (LayerNorm biases, attention biases, the frontend)."""
    a, _b = hoisted_case(WHISPER_ARCH)
    hoisted = psmol.prequantize_tree(a["model"], a["model"].cfg.quant)
    assert len(hoisted) == 2 * 6 + 2 * 10 and "frontend" not in hoisted
    assert "blocks.1.cross.wv" in hoisted and "enc_blocks.0.mlp.down" in \
        hoisted
    assert set(a["err"]) == {n for n, _ in a["model"].named_parameters()}
    for leaf in ("frontend.w", "enc_blocks.1.ln_ffn.b", "blocks.0.cross.wo.w",
                 "enc_norm.g"):
        assert a["err"][leaf].abs().sum() > 0, leaf


# ------------------------------------------------ loop and checkpoints ----
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's ``loop.train`` (``LOOP_TK``: steps
    0-1 Phase I, the boundary, 2-3 Phase II) from the same spread model,
    batches with frames and replayed draws, each checkpointing at steps 2
    and 4; their Phase-II steps and the continued runs under
    ``_same_knife_edge`` (without it the port's continuation of the
    reference's checkpoint lands up to 1.43e-4 from the reference's run:
    Adam steps of gradients whose sign a knife-edge mask flipped)."""
    jd = str(tmp_path_factory.mktemp("jax_ckpt"))
    pd = str(tmp_path_factory.mktemp("port_ckpt"))
    with _same_knife_edge():
        jout, pout = loop_train_runs(WHISPER_ARCH, jax_ckpt=jd, port_ckpt=pd)
    return jd, pd, jout, pout


def test_loop_train_equals_jax(runs):
    """The history within 1e-4, the report (the encoder's linears first,
    path by path) and the frozen pbits of every linear equal, the encoder's
    and the cross attention's included."""
    _jd, _pd, jout, pout = runs
    assert_loop_train_equal(jout, pout)
    assert len(pout["pattern_report"]["layers"]) == 2 * 6 + 2 * 10


def test_jax_checkpoint_continues_on_the_port(runs, tmp_path):
    """JAX -> port: the reference's step-2 checkpoint (``enc_groups``,
    ``enc_norm``, ``frontend`` and their moments) restored by the port,
    which runs the boundary and steps 2-3 on the stream's frames: the
    report equal, losses and parameters within 1e-4 of the reference's
    uninterrupted run."""
    jd, _pd, jout, _pout = runs
    jcfg, pcfg = _configs(arch=WHISPER_ARCH)
    d = _step_dir(jd, 2, str(tmp_path / "ck"))
    with _same_knife_edge():
        out = ploop.train(pcfg, pstate.TrainConfig(ckpt_dir=d, **LOOP_TK),
                          itertools.islice(loop_stream(jcfg), 2, None),
                          device="cpu")
    assert [m["step"] for m in out["history"]] == [2, 3]
    _assert_continues(out["history"], out["pattern_report"],
                      interop.tree_to_numpy(out["state"]["model"]), jout)


def test_port_checkpoint_continues_on_jax(runs, tmp_path):
    """Port -> JAX: the port's step-2 checkpoint restored by the
    reference's loop, which runs the boundary and steps 2-3: the report
    equal, losses and parameters within 1e-4 of its uninterrupted run."""
    _jd, pd, jout, _pout = runs
    jcfg, _pcfg = _configs(arch=WHISPER_ARCH)
    d = _step_dir(pd, 2, str(tmp_path / "ck"))
    with _true_division(), _same_knife_edge():
        out = jloop.train(jcfg, jstate.TrainConfig(ckpt_dir=d, **LOOP_TK),
                          itertools.islice(loop_stream(jcfg), 2, None))
    assert [m["step"] for m in out["history"]] == [2, 3]
    _assert_continues(out["history"], out["pattern_report"],
                      jax.device_get(out["state"]["params"]), jout)


def test_trained_model_serves_the_reference_tokens(runs):
    """The reference-trained QAT params packed by the port's
    ``DecodeEngine`` (one B7 call a linear: 32) and served after
    ``load_cross`` of each package's own ``encode`` of the
    same frames: the greedy tokens equal the JAX ``DecodeEngine``'s on
    that packing; the encoder outputs within 1e-4. The port-trained model
    serves too."""
    _jd, _pd, jout, pout = runs
    jcfg, pcfg = _configs(arch=WHISPER_ARCH)
    qcfg = pcfg.with_quant_mode("qat")
    frames = np.random.default_rng(9).standard_normal(
        (3, 24, pcfg.frontend_dim)).astype(np.float32)
    eng = pengine.DecodeEngine(interop.params_from_numpy(
        jax.device_get(jout["state"]["params"]), qcfg, "cpu"), qcfg,
        pengine.EngineConfig(**ENGINE), device="cpu")
    jeng = jengine.DecodeEngine(
        interop.tree_to_numpy(eng.model), jcfg.with_quant_mode("qat"),
        jengine.EngineConfig(backend="xla_ref", **ENGINE),
        already_serve=True)
    jenc = np.asarray(_compile_as_written(
        lambda p, f: jlm.encode(p, jeng.cfg, f), jeng.params, frames)(
            jeng.params, frames))
    with torch.no_grad():
        penc = plm.encode(eng.model, eng.cfg, frames)
    np.testing.assert_allclose(penc.numpy(), jenc, rtol=1e-4, atol=1e-4)
    got = _tokens_of(eng, _requests(PRequest), penc)
    want = _tokens_of(jeng, _requests(JRequest), jenc)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    own = pengine.DecodeEngine(pout["state"]["model"], qcfg,
                               pengine.EngineConfig(**ENGINE), device="cpu")
    with torch.no_grad():
        out = _tokens_of(own, _requests(PRequest),
                         plm.encode(own.model, own.cfg, frames))
    assert all(((t >= 0) & (t < pcfg.vocab_size)).all()
               for t in out.values())


# --------------------------------------------------------------- façade ----
def test_facade_trains_freezes_and_serves_whisper():
    """``soniq.apply(frames=)`` at NOISE against the reference's jitted
    ``soniq.apply`` on replayed draws (logits 1e-4); one Phase-I step;
    ``soniq.to_qat``: the pbits and the report equal the reference's
    ``freeze_qat`` on the same trained logits; ``to_serve`` (one B7 call a
    linear): the served model's greedy tokens after ``load_cross`` equal
    the ``DecodeEngine``'s packing of the same QAT model."""
    jcfg, pcfg = _configs(arch=WHISPER_ARCH)
    ncfg = pcfg.with_quant_mode("noise")
    state = soniq.init(ncfg, seed=4, device="cpu")
    jnoise = jcfg.with_quant_mode("noise")
    tree = interop.tree_to_numpy(state.model)
    jst = jsoniq.SoniqState(jsoniq.Phase.NOISE,
                            jax.tree.map(jnp.asarray, tree), jnoise)
    tokens = np.random.default_rng(6).integers(
        0, pcfg.vocab_size, (2, 16)).astype(np.int32)
    frames = np.random.default_rng(7).standard_normal(
        (2, 24, pcfg.frontend_dim)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    with _true_division():
        want = np.asarray(jax.jit(lambda s, t, f: jsoniq.apply(
            s, t, frames=f, rng=key))(jst, tokens, frames))
    with torch.no_grad():
        got = soniq.apply(state, tokens, frames=frames,
                          noise=JaxDraws(key_paths_of(key, pcfg)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    tcfg = pstate.TrainConfig(warmup=1, t1=1, t2=2)
    st = pstate.init_state(ncfg, tcfg, model=state.model)
    pstate.train_step(st, _batch(pcfg, 5), ncfg, tcfg,
                      pstate.step_noise(1, 0))
    # Sorted keys, as the reference's own trees hold them.
    jnew, jrep = jtransforms.freeze_qat(jax.tree.map(
        np.asarray, interop.tree_to_numpy(state.model)), jnoise.quant)
    qat, report = soniq.to_qat(state)
    assert report["allowed"] == jrep["allowed"]
    assert report["layers"] == jrep["layers"]
    assert pschedule.average_bpp(report) == jschedule.average_bpp(jrep)
    for jl, pl in zip(_stacked_linears(jnew),
                      _stacked_linears(interop.tree_to_numpy(qat.model))):
        assert "s" not in pl
        np.testing.assert_array_equal(pl["pbits"], np.asarray(jl["pbits"]))
    twin = copy.deepcopy(qat.model)
    served = soniq.to_serve(qat)
    assert "w4" in served.model.enc_blocks[1].mlp.up._names
    assert "w4" in served.model.blocks[0].cross.wk._names
    assert "w4" not in served.model.frontend._names
    ecfg = pengine.EngineConfig(**ENGINE)
    srv = pengine.DecodeEngine(served.model, served.model_cfg, ecfg,
                               already_serve=True, device="cpu")
    ref = pengine.DecodeEngine(twin, pcfg.with_quant_mode("qat"), ecfg,
                               device="cpu")
    with torch.no_grad():
        enc = plm.encode(ref.model, ref.cfg, frames[:1].repeat(3, 0))
    assert _tokens_of(srv, _requests(PRequest), enc).keys() == \
        _tokens_of(ref, _requests(PRequest), enc).keys()
    a = _tokens_of(srv, _requests(PRequest), enc)
    b = _tokens_of(ref, _requests(PRequest), enc)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


# -------------------------------------------------------------- profile ----
def test_step_profile_counts_whisper_ops_apart():
    """``tools/step_profile.py`` under ``WHISPER_TRAIN_SPANS``: the float64
    attention, the LayerNorm and the GELU label their forward ops (and
    their recompute) and, as ``<label>_bwd``, the autograd nodes those
    made (the GELU's own backward node by name)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import step_profile
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import checkpoint
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(0, 1, (1, 6, 8)).astype(np.float32),
                     requires_grad=True)
    g, b = torch.ones(8, requires_grad=True), torch.zeros(8,
                                                          requires_grad=True)

    def block(x_):
        h = pcommon.layer_norm(g, b, x_)
        q = h.reshape(1, 6, 2, 1, 4)
        k = h.reshape(1, 6, 2, 4)
        o = pattention.sdpa(q, k, k, None).reshape(1, 6, 8)
        return pcommon.activation("gelu")(o)

    undo = step_profile.install_spans(step_profile.WHISPER_TRAIN_SPANS)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            y = checkpoint(block, x, use_reentrant=False)
            (y.exp() * 2).sum().backward()
    finally:
        undo()
    events = prof.events()
    labels = step_profile.forward_labels(events)
    nodes = {}
    for e in events:
        if e.name.startswith(step_profile.NODE):
            nodes.setdefault(step_profile._label(e, labels), set()).add(
                e.name[len(step_profile.NODE):])
    assert {"layer_norm", "attention", "gelu"} <= set(labels.values()) \
        <= {"layer_norm", "attention", "gelu", "gelu_bwd"}
    assert {"layer_norm_bwd", "attention_bwd", "gelu_bwd"} <= set(nodes)
    assert "_GeluBackward" in nodes["gelu_bwd"]
    assert "ExpBackward0" in nodes[None]


# ------------------------------------------------------------ launcher ----
RUN = (
    "import runpy, sys\n"
    "sys.argv = {argv!r}\n"
    "try:\n"
    "    runpy.run_module(sys.argv[0], run_name='__main__')\n"
    "except ValueError as e:\n"
    "    print('refused:', e)\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
    "assert not bad, bad\n"
    "print('no jax loaded')\n")


def test_train_launcher_needs_frames_for_whisper():
    """``launch.train --arch whisper-medium`` fails at its first step on
    the missing frames, as the reference's launcher does (it feeds only a
    ``TokenStream``), in a subprocess that loads no jax."""
    argv = ["repro_torch.launch.train", "--arch", WHISPER_ARCH, "--reduced",
            "--device", "cpu", "--steps", "2", "--t1", "1", "--batch", "2",
            "--seq", "16"]
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(argv=argv)], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "refused: an encoder-decoder arch needs frames" in out.stdout
    assert "step 0" not in out.stdout
    assert out.stdout.rstrip().endswith("no jax loaded")
