"""Port parity for VLM training (qwen2-vl-72b, reduced, 2 layers: d_model
128, 4 heads of 32 over 2 KV heads, d_ff 256 SwiGLU, attention and MLP
biases, an untied readout, M-RoPE sections (8, 4, 4); fp32) against the
JAX package on the CPU: one ``train_step`` at NOISE and QAT on
precomputed embeddings and [3, B, S] position streams with every leaf's
gradient, the embedding table's zero gradient and its weight decay,
``split_microbatches`` on the streams, ``loop.train`` through Phase I, the
freeze and Phase II, and checkpoints continued in both directions.

A batch row is 4 text tokens, a 4 x 4 image (16 patches sharing one
temporal position) and 4 text tokens, laid out on the three streams as
Qwen2-VL lays them (``mrope_positions``); the embeddings are seeded
normals (the vision tower is a stub in both packages) and the labels are
-1 on the image. NOISE replays the reference's draws (``JaxDraws``); the
reference's steps are jitted with the abs-max scale divisions kept true
(``_true_division``)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train import state as jstate

from repro_torch import interop
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm as plm
from repro_torch.optim import adamw as padamw
from repro_torch.train import loop as ploop
from repro_torch.train import state as pstate

from test_torch_ssm_train import _assert_continues, _step_dir, rel_l2
from test_torch_train import (LOOP_TK, JaxDraws, _configs, _random_s,
                              _true_division, assert_loop_train_equal,
                              key_paths_of, loop_train_runs)
from test_torch_vlm import mrope_positions, vision_mask
from test_torch_whisper_train import _float_leaves, _jax_tree

ARCH = "qwen2-vl-72b"
REL_L2 = 1e-5
# 4 text tokens, a 4 x 4 image, 4 text tokens: 24 a row.
LAYOUT = (("text", 4), ("vision", 1, 4, 4), ("text", 4))


def vlm_batch(cfg, rng, b=2):
    """{embeds fp32 [b, S, D] (seeded normals at the table's scale 0.02),
    positions int32 [3, b, S], labels int32 [b, S] (-1 on the image)}."""
    pos = mrope_positions(LAYOUT)
    s = pos.shape[1]
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, vision_mask(LAYOUT)] = -1
    return {"embeds": rng.normal(0, 0.02, (b, s, cfg.d_model)).astype(
                np.float32),
            "positions": np.ascontiguousarray(np.broadcast_to(
                pos[:, None], (3, b, s))),
            "labels": labels}


def vlm_stream(jcfg):
    """The loop runs' batches, from ``default_rng(2)``."""
    rng = np.random.default_rng(2)
    while True:
        yield vlm_batch(jcfg, rng)


# -------------------------------------------------------- train step ----
@pytest.mark.parametrize("mode", ["noise", "qat"])
def test_train_step_equals_jax(mode):
    """One step of the 2-layer model from the reference's weights (NOISE:
    logits spread over the bands, the reference's draws replayed) on
    embeddings and M-RoPE streams: the loss within rtol 1e-5 of the
    reference's, every leaf's gradient within relative L2 1e-5 of
    ``jax.grad`` (the attention and MLP biases, the untied ``lm_head``; a
    key bias's gradient, zero up to rounding, against its query bias's).
    The embedding table is not read, so its gradient is zero in both
    (``train_step`` hands AdamW zeros, as ``jax.grad`` does), and the step
    decays it as the reference's AdamW does; the gradient norm within
    rtol 1e-5."""
    jcfg, pcfg = _configs(arch=ARCH)
    jcfg, pcfg = jcfg.with_quant_mode(mode), pcfg.with_quant_mode(mode)
    tree = _jax_tree(jcfg)
    if mode == "noise":
        tree = _random_s(jax.tree.map(np.array, tree),
                         np.random.default_rng(3))
    batch = vlm_batch(jcfg, np.random.default_rng(1))
    key = jax.random.PRNGKey(17)

    def jloss(p, b, k):
        return jlm.loss_fn(p, b, jcfg, k if mode == "noise" else None)[0]

    with _true_division():
        jl, jg = jax.jit(jax.value_and_grad(jloss, allow_int=True))(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = JaxDraws(key_paths_of(key, pcfg))
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    model.requires_grad_(True)
    loss, _ = plm.loss_fn(model, batch, pcfg,
                          draws if mode == "noise" else None)
    names, params = zip(*padamw.trainable(model))
    grads = dict(zip(names, torch.autograd.grad(loss, params,
                                                allow_unused=True)))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = _float_leaves(jg, pcfg)
    assert set(want) == set(names)
    assert {"lm_head.w", "blocks.1.attn.wk.b", "blocks.0.mlp.down.b",
            "embed.table"} <= set(names)
    assert grads["embed.table"] is None
    assert not want["embed.table"].any()
    errs = {}
    for name, g in grads.items():
        if name == "embed.table":
            continue
        if name.endswith(".wk.b"):
            scale = np.linalg.norm(want[name.replace(".wk.b", ".wq.b")])
            errs[name] = float(np.linalg.norm(
                g.numpy().astype(np.float64) - want[name]) / scale)
        else:
            errs[name] = rel_l2(g, want[name])
    assert max(errs.values()) <= REL_L2, sorted(
        errs.items(), key=lambda kv: -kv[1])[:6]
    # The step: the table decays by AdamW's rule on its zero gradient.
    pt = pstate.TrainConfig(warmup=1, t1=1 if mode == "noise" else 0, t2=4)
    st = pstate.init_state(pcfg, pt, model=interop.params_from_numpy(
        tree, pcfg, "cpu"))
    st["step"] = 1
    _, met = pstate.train_step(st, batch, pcfg, pt,
                               (lambda i: draws) if mode == "noise"
                               else None)
    np.testing.assert_allclose(float(met["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jadamw.global_norm(jg)), rtol=1e-5)
    jnew, _, _ = jadamw.apply_updates(tree, jg, jadamw.init_state(tree),
                                      pt.adamw,
                                      lr_scale=float(met["lr_scale"]))
    table = st["model"].embed.table.detach().numpy()
    assert not np.array_equal(table, tree["embed"]["table"])
    np.testing.assert_allclose(table, np.asarray(jnew["embed"]["table"]),
                               rtol=1e-6, atol=1e-9)


def test_split_microbatches_equals_jax():
    """Two microbatches of embeddings, labels and the [3, B, S] streams
    (split along the streams' batch axis, 1) equal the reference's
    ``_split_microbatches``; a 2-microbatch step is finite."""
    jcfg, pcfg = _configs(arch=ARCH)
    batch = vlm_batch(jcfg, np.random.default_rng(4), b=4)
    want = jstate._split_microbatches(
        {k: jnp.asarray(v) for k, v in batch.items()}, 2)
    got = pstate.split_microbatches(batch, 2)
    assert len(got) == 2
    for i, mb in enumerate(got):
        assert set(mb) == set(want)
        for k, v in mb.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(want[k][i]))
    assert got[1]["positions"].shape == (3, 2, 24)
    qcfg = pcfg.with_quant_mode("qat")
    tcfg = pstate.TrainConfig(num_microbatches=2, warmup=1, t1=0, t2=4)
    st = pstate.init_state(qcfg, tcfg, model=plm.init_params(
        qcfg, seed=0, device="cpu"))
    _, met = pstate.train_step(st, batch, qcfg, tcfg)
    assert np.isfinite(float(met["loss"]))


# ------------------------------------------------ loop and checkpoints ----
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's ``loop.train`` (``LOOP_TK``: steps
    0-1 Phase I, the boundary, 2-3 Phase II) from the same spread model on
    the same embedding batches and replayed draws, each checkpointing at
    steps 2 and 4."""
    jd = str(tmp_path_factory.mktemp("jax_ckpt"))
    pd = str(tmp_path_factory.mktemp("port_ckpt"))
    jout, pout = loop_train_runs(ARCH, jax_ckpt=jd, port_ckpt=pd,
                                 stream=vlm_stream)
    return jd, pd, jout, pout


def test_loop_train_equals_jax(runs):
    """The history within 1e-4, the freeze's report and every linear's
    frozen pbits equal."""
    _jd, _pd, jout, pout = runs
    assert_loop_train_equal(jout, pout)
    assert len(pout["pattern_report"]["layers"]) == 2 * 7


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_continues_across_packages(runs, tmp_path, direction):
    """One package's step-2 checkpoint (Phase-I parameters, the attention
    and MLP biases, ``lm_head`` and their moments) restored by the other,
    which runs the boundary and steps 2-3 on the stream's batches: the
    report equal and the losses within 1e-4 of the reference's
    uninterrupted run, the parameters within 1e-4 of the restoring
    package's own uninterrupted run. The two uninterrupted runs differ at
    6 elements of layer 0's ``wv`` by 1.58e-4: Phase II's STE masks the
    abs-max element of a weight group, whose |w / s| rounds to the grid
    top or one step above it as the last bit of w falls (ROADMAP §C), and
    the packages' weights differ in that bit after two steps."""
    jd, pd, jout, pout = runs
    jcfg, pcfg = _configs(arch=ARCH)
    tk = dict(LOOP_TK)
    rest = itertools.islice(vlm_stream(jcfg), 2, None)
    if direction == "jax_to_port":
        d = _step_dir(jd, 2, str(tmp_path / "ck"))
        out = ploop.train(pcfg, pstate.TrainConfig(ckpt_dir=d, **tk), rest,
                          device="cpu")
        params = interop.tree_to_numpy(out["state"]["model"])
        own = interop.tree_to_numpy(pout["state"]["model"])
    else:
        d = _step_dir(pd, 2, str(tmp_path / "ck"))
        with _true_division():
            out = jloop.train(jcfg, jstate.TrainConfig(ckpt_dir=d, **tk),
                              rest)
        params = jax.device_get(out["state"]["params"])
        own = jax.device_get(jout["state"]["params"])
    assert [m["step"] for m in out["history"]] == [2, 3]
    _assert_continues(out["history"], out["pattern_report"], params,
                      dict(jout, state={"params": own}))


def test_train_launcher_trains_qwen2_vl(capsys):
    """``--arch qwen2-vl-72b --reduced`` trains through Phase I, the
    boundary and Phase II on text tokens, as the reference's launcher
    feeds it."""
    assert train_launcher.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--steps", "3", "--t1", "1",
                                "--batch", "2", "--seq", "8"]) == 0
    out = capsys.readouterr().out
    assert out.count("phase 1:") == 1 and out.count("phase 2:") == 2
    assert "boundary: average bpp" in out and out.rstrip().endswith("done")
