"""Port parity for the rest of training, against the JAX package on the
CPU: int8 error-feedback gradient compression (leaf and tree, bitwise),
the fault-tolerance policies (``train/ft.py``), the hoisted weight
quantization (``smol.prequantize_tree`` on a 2-D linear and on expert
banks; a hoisted 2-microbatch QAT ``train_step`` bitwise the unhoisted one
and against the reference's hoisted step), the fresh fp32 moments at the
Phase I -> II boundary, and the launcher's ``--ckpt``, ``--hoist`` and
``--grad-compress``.

The reference's compression is compared eagerly: jitted, XLA contracts
``gf - q * scale`` into one fused multiply-add, where the reference's
eager ops, and the port's, round twice.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import smol as jsmol
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.data import synthetic as jsynthetic
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.train import ft as jft
from repro.train import state as jstate

from repro_torch import interop
from repro_torch.core import smol as psmol
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.kernels import fake_quant as pfq
from repro_torch.launch import train as ptrain_launch
from repro_torch.models import lm as plm
from repro_torch.optim import adamw as padamw
from repro_torch.optim import grad_compress as pgc
from repro_torch.train import ft as pft
from repro_torch.train import loop as ploop
from repro_torch.train import state as pstate

from test_torch_moe_train import _configs as moe_configs, _tree as moe_tree
from test_torch_train import (_abs_diffs, _configs, _jax_params,
                              _true_division)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


# ------------------------------------------------------- grad compression ----
def _grad_cases():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((64, 48)).astype(np.float32)
    ties = np.array([0.5, -1.5, 2.5, 127.0, -127.0, 3.25, 0.0, -0.0],
                    np.float32)
    return {"normal": (g, np.zeros_like(g)),
            "with_error": (g, (rng.standard_normal(g.shape) * 1e-2
                               ).astype(np.float32)),
            "ties": (ties, np.zeros_like(ties)),
            "zeros": (np.zeros((5,), np.float32), np.zeros((5,), np.float32)),
            "tiny": ((rng.standard_normal(7) * 1e-14).astype(np.float32),
                     np.zeros((7,), np.float32))}


@pytest.mark.parametrize("case", sorted(_grad_cases()))
def test_compress_leaf_equals_jax_bitwise(case):
    g, err = _grad_cases()[case]
    jq, js, je = jgc.compress_leaf(jnp.asarray(g), jnp.asarray(err))
    pq, ps, pe = pgc.compress_leaf(torch.tensor(g), torch.tensor(err))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert _bits(ps.numpy()).tobytes() == _bits(js).tobytes()
    np.testing.assert_array_equal(_bits(pe.numpy()), _bits(je))
    np.testing.assert_array_equal(
        _bits(pgc.decompress_leaf(pq, ps).numpy()),
        _bits(jgc.decompress_leaf(jq, js)))


def test_compress_tree_equals_jax_bitwise():
    """A tree with an integer leaf (None in the error tree, passed
    through), keyed by path in the port, through two rounds of error
    feedback."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((8,)).astype(np.float32),
            "n": {"b": (rng.standard_normal((4, 3)) * 5).astype(np.float32)},
            "i": np.array([1, 2], np.int8)}
    paths = {"a": ("a",), "n.b": ("n", "b"), "i": ("i",)}

    def at(t, key):
        for k in paths[key]:
            t = t[k]
        return t

    jerr = jgc.init_error_tree(jax.tree.map(jnp.asarray, tree))
    perr = pgc.init_error_tree({k: torch.tensor(at(tree, k)) for k in paths})
    assert perr["i"] is None and jerr["i"] is None
    for _ in range(2):
        jq, jerr = jgc.compress_tree(jax.tree.map(jnp.asarray, tree), jerr)
        pq, perr = pgc.compress_tree(
            {k: torch.tensor(at(tree, k)) for k in paths}, perr)
        jout, pout = jgc.decompress_tree(jq), pgc.decompress_tree(pq)
        for k in ("a", "n.b"):
            np.testing.assert_array_equal(_bits(pout[k].numpy()),
                                          _bits(at(jout, k)))
            np.testing.assert_array_equal(_bits(perr[k].numpy()),
                                          _bits(at(jerr, k)))
        np.testing.assert_array_equal(pout["i"].numpy(), tree["i"])
        assert perr["i"] is None


def test_compress_error_feedback_unbiased():
    """The reference's drift bound (``tests/test_train_substrate.py``):
    20 compressions of one gradient with error feedback; the running mean
    of what was sent tracks the gradient within one code step."""
    g = torch.tensor(np.random.default_rng(0).normal(0, 1, (256,))
                     .astype(np.float32))
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(20):
        q, scale, err = pgc.compress_leaf(g, err)
        total = total + pgc.decompress_leaf(q, scale)
    drift = float(torch.max(torch.abs(total / 20 - g)))
    assert drift < float(torch.max(torch.abs(g))) / 127 + 1e-5


# -------------------------------------------------------------------- ft ----
def test_heartbeats_equal_jax():
    beats = [(0, 1000.0), (1, 1000.0), (2, 1000.0), (0, 1020.0),
             (1, 1020.0), (3, 1005.0)]
    mons = [m.HeartbeatMonitor([0, 1, 2, 3], timeout=10.0)
            for m in (jft, pft)]
    for mon in mons:
        for h, t in beats:
            mon.beat(h, t)
    for now in (1009.0, 1016.0, 1021.0, 1031.0):
        assert mons[1].failed_hosts(now) == mons[0].failed_hosts(now)
        assert mons[1].surviving(now) == mons[0].surviving(now)
    assert mons[1].failed_hosts(1000.0) == [0, 1, 2, 3]    # sticky


@pytest.mark.parametrize("patience", [1, 3])
def test_stragglers_equal_jax(patience):
    rng = np.random.default_rng(patience)
    mons = [m.StragglerMonitor([0, 1, 2, 3, 4], ratio=1.5,
                               patience=patience) for m in (jft, pft)]
    for step in range(8):
        times = rng.uniform(0.9, 1.1, 5)
        times[3] *= 3.0 if step >= 2 else 1.0
        for mon in mons:
            for h, t in enumerate(times):
                mon.record(h, float(t))
        out = [mon.stragglers() for mon in mons]
        assert out[1] == out[0]
    assert out[1] == [3]


@pytest.mark.parametrize("survivors,model,chips", [
    (60, 16, 4), (64, 16, 4), (5, 4, 4), (4, 16, 4), (33, 8, 8), (3, 2, 1)])
def test_plan_remesh_equals_jax(survivors, model, chips):
    assert pft.plan_remesh(survivors, model=model, chips_per_host=chips) \
        == jft.plan_remesh(survivors, model=model, chips_per_host=chips)


def test_plan_remesh_refuses_too_few_chips():
    with pytest.raises(AssertionError):
        jft.plan_remesh(3, model=16, chips_per_host=4)
    with pytest.raises(ValueError):
        pft.plan_remesh(3, model=16, chips_per_host=4)


@pytest.mark.parametrize("args", [(256, 16, 8, 1), (256, 16, 4, 2),
                                  (96, 8, 3, 1), (8, 8, 1, 1)])
def test_rescale_microbatches_equals_jax(args):
    assert pft.rescale_microbatches(*args) == jft.rescale_microbatches(*args)


# ------------------------------------------------------------ prequantize ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prequantize_linear_equals_jax(dtype):
    """A 2-D QAT linear with mixed precisions: one B8 call, cast to the
    compute dtype; its gradient (the clipped STE) through the reference's
    ``jax.vjp``."""
    rng = np.random.default_rng(5)
    k, n = 128, 96
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    w[:16] *= 4.0                   # a group beyond the grid of the others
    pbits = rng.choice(np.array([1, 2, 4], np.int8), k // 16)
    cot = rng.standard_normal((k, n)).astype(np.float32)
    qcfg = JQuantConfig(mode="qat", backend="xla_ref")
    jdt = jnp.dtype(dtype)
    with _true_division():
        jw, vjp = jax.vjp(lambda t: jsmol.prequantize_tree(
            t, qcfg, jdt), {"l": {"w": jnp.asarray(w),
                                  "pbits": jnp.asarray(pbits)}})
        jdw = vjp({"l": {"w": jnp.asarray(cot).astype(jdt),
                         "pbits": np.zeros(pbits.shape, jax.dtypes.float0)}}
                  )[0]["l"]["w"]
    lin = psmol.SmolLinear({"w": torch.tensor(w),
                            "pbits": torch.tensor(pbits)})
    lin.requires_grad_(True)
    model = torch.nn.Module()
    model.l = lin
    calls = pfq.LAUNCHES["fake_quant"]
    out = psmol.prequantize_tree(model, PQuantConfig(mode="qat"),
                                 getattr(torch, dtype))
    assert list(out) == ["l"] and out["l"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out["l"].detach().float().numpy(),
                                  np.asarray(jw["l"]["w"], np.float32))
    (pdw,) = torch.autograd.grad(out["l"], [lin.w],
                                 torch.tensor(cot).to(out["l"].dtype))
    np.testing.assert_array_equal(pdw.numpy(), np.asarray(jdw))
    assert pfq.LAUNCHES["fake_quant"] == calls   # plain version on the CPU


def test_prequantize_banks_equal_jax():
    """Reduced deepseek-moe-16b (a dense layer, an MoE layer with shared
    experts): every quantized linear and [E, K, N] bank prequantized as
    the reference's ``vmap`` does, one leaf a linear or bank."""
    jcfg, pcfg = moe_configs("deepseek-moe-16b", "qat")
    tree = moe_tree(jcfg, 13)
    with _true_division():
        jout = jsmol.prequantize_tree(jax.tree.map(jnp.asarray, tree),
                                      jcfg.quant, jnp.float32)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    out = psmol.prequantize_tree(model, pcfg.quant, torch.float32)
    banks = [p for p in out if p.endswith(("moe.up", "moe.gate",
                                           "moe.down"))]
    assert len(banks) == 3 and out["blocks.1.moe.up"].shape == (
        pcfg.num_experts, pcfg.d_model, pcfg.d_ff)
    assert len(out) == 7 + 4 + 3 + 3
    with torch.no_grad():
        for path, lin in psmol.smol_linears(model):
            if path in out:
                lin.w.copy_(out[path])
    back = dict(jax.tree_util.tree_flatten_with_path(
        interop.tree_to_numpy(model))[0])
    for path, want in jax.tree_util.tree_flatten_with_path(jout)[0]:
        np.testing.assert_array_equal(back[path], np.asarray(want))


# ------------------------------------------------------------ hoisted step ----
def _step_setup(mode="qat"):
    jcfg, pcfg = _configs()
    jcfg, pcfg = jcfg.with_quant_mode(mode), pcfg.with_quant_mode(mode)
    batch = next(jsynthetic.TokenStream(jsynthetic.TokenStreamConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, batch_size=4,
        seed=1)).batches())
    return jcfg, pcfg, _jax_params(jcfg), batch


def _port_step(tree, pcfg, batch, **tk):
    pt = pstate.TrainConfig(adamw=padamw.AdamWConfig(lr=1e-3), warmup=1,
                            t1=0, t2=4, **tk)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    st = pstate.init_state(pcfg, pt, model=model)
    st["step"] = 1
    st, met = pstate.train_step(st, batch, pcfg, pt)
    return st, met


def test_hoisted_step_is_the_unhoisted_step_bitwise():
    """A 2-microbatch QAT step hoisted (one B8 call a weight, the summed
    gradient backward through it once) and unhoisted (a B8 call a weight
    in every microbatch): the same loss, gradient norm and parameters,
    bit for bit; also with compression, the same error."""
    _, pcfg, tree, batch = _step_setup()
    for compress in (False, True):
        runs = [_port_step(tree, pcfg, batch, num_microbatches=2,
                           hoist_weight_quant=h, grad_compress=compress)
                for h in (False, True)]
        (a, ma), (b, mb) = runs
        for key in ("loss", "grad_norm", "moe_aux"):
            assert float(ma[key]) == float(mb[key]), key
        for (n, x), (_, y) in zip(a["model"].named_parameters(),
                                  b["model"].named_parameters()):
            assert torch.equal(x, y), n
        if compress:
            for n in a["err"]:
                assert torch.equal(a["err"][n], b["err"][n]), n


def test_hoisted_step_equals_jax():
    """The hoisted 2-microbatch QAT step against the reference's hoisted
    ``train_step`` at the bounds of ``tests/test_torch_train.py``: loss
    and gradient norm rtol 1e-5; parameters within 2e-6 but for at most 1
    in 10,000 elements, all within 1e-4."""
    jcfg, pcfg, tree, batch = _step_setup()
    tk = dict(num_microbatches=2, hoist_weight_quant=True)
    jt = jstate.TrainConfig(adamw=jadamw.AdamWConfig(lr=1e-3), warmup=1,
                            t1=0, t2=4, **tk)
    jst = {"params": tree, "opt": jadamw.init_state(tree),
           "step": jnp.ones((), jnp.int32)}
    with _true_division():
        jnew, jm = jax.jit(lambda s, b, r: jstate.train_step(
            s, b, jcfg, jt, r))(jst, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                                jax.random.PRNGKey(3))
    pst, pm = _port_step(tree, pcfg, batch, **tk)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    diffs = np.concatenate(_abs_diffs(interop.tree_to_numpy(pst["model"]),
                                      jax.device_get(jnew["params"])))
    assert diffs.max() <= 1e-4
    assert (diffs > 2e-6).mean() <= 1e-4


def test_compressed_steps_send_the_reference_codes():
    """Two compressed steps (hoisted, 2 microbatches): the gradients the
    step hands AdamW and the error it keeps are, bitwise, the reference's
    eager ``compress_leaf`` of the step's own gradients and error. (A step
    against the reference's step is not bitwise: gradients that agree to
    ~1e-6 relative still cross a code's rounding edge now and then, a
    whole code step. Unhoisted, the reference's compression fails on QAT
    with microbatches: its scan leaves None at the integer leaves, which
    misaligns the error tree.)"""
    _, pcfg, tree, batch = _step_setup()
    pt = pstate.TrainConfig(warmup=1, t1=0, t2=4, num_microbatches=2,
                            hoist_weight_quant=True, grad_compress=True)
    st = pstate.init_state(pcfg, pt, model=interop.params_from_numpy(
        tree, pcfg, "cpu"))
    seen = []
    real_compress, real_apply = pgc.compress_tree, padamw.apply_updates

    def spy_compress(grads, err):
        seen.append({"g": {k: v.clone() for k, v in grads.items()},
                     "err": {k: v.clone() for k, v in err.items()}})
        return real_compress(grads, err)

    def spy_apply(model, grads, *a, **kw):
        seen[-1]["sent"] = {k: v.clone() for k, v in grads.items()}
        return real_apply(model, grads, *a, **kw)

    with mock.patch.object(pgc, "compress_tree", spy_compress), \
            mock.patch.object(padamw, "apply_updates", spy_apply):
        for _ in range(2):
            st, _m = pstate.train_step(st, batch, pcfg, pt)
    kept = [rec["err"] for rec in seen[1:]] + [st["err"]]
    for rec, new_err in zip(seen, kept):
        assert rec["g"].keys() == rec["sent"].keys()
        for path, g in rec["g"].items():
            jq, js, je = jgc.compress_leaf(jnp.asarray(g.numpy()),
                                           jnp.asarray(rec["err"][path]
                                                       .numpy()))
            np.testing.assert_array_equal(
                _bits(rec["sent"][path].numpy()),
                _bits(jgc.decompress_leaf(jq, js)), err_msg=path)
            np.testing.assert_array_equal(_bits(new_err[path].numpy()),
                                          _bits(je), err_msg=path)


# -------------------------------------------------------------- boundary ----
def test_boundary_moments_are_fp32():
    """With ``moment_dtype="bfloat16"`` Phase I keeps bf16 moments; the
    boundary's fresh moments are fp32 whatever the setting, as the
    reference's ``adamw.init_state(params)`` (``train/loop.py:69``)."""
    _, pcfg = _configs(layers=1)
    tcfg = pstate.TrainConfig(
        adamw=padamw.AdamWConfig(moment_dtype="bfloat16"), t1=1, t2=2,
        warmup=1, seed=2)
    stream = jsynthetic.TokenStream(jsynthetic.TokenStreamConfig(
        vocab_size=pcfg.vocab_size, seq_len=8, batch_size=2, seed=0))
    dtypes = {}

    def hook(step, st, _m):
        dtypes[step] = {t.dtype for t in st["opt"]["mu"].values()} | {
            t.dtype for t in st["opt"]["nu"].values()}

    ploop.train(pcfg, tcfg, stream.batches(), device="cpu", hooks=[hook])
    assert dtypes == {0: {torch.bfloat16}, 1: {torch.float32}}


# -------------------------------------------------------------- launcher ----
def test_launcher_checkpoints_hoists_and_compresses(tmp_path, capsys):
    """The launcher on the CPU with ``--ckpt``, ``--hoist`` and
    ``--grad-compress``: Phase I, the boundary, hoisted compressed Phase-II
    steps, a checkpoint in the reference's layout (with ``err``); a second
    call resumes from it and trains on; the serve launcher loads it."""
    ck = str(tmp_path / "ck")
    common = ["--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu",
              "--t1", "2", "--batch", "2", "--seq", "16", "--microbatches",
              "2", "--ckpt", ck, "--hoist", "--grad-compress"]
    assert ptrain_launch.main(common + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "resumed" not in out and out.count("phase 2:") == 2
    assert ptrain_launch.main(common + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert "step 4 phase 2" in out and "step 5 phase 2" in out
    from repro_torch.train import checkpoint as pckpt
    tree, step = pckpt.restore(ck)
    assert step == 6 and "err" in tree
    assert tree["opt"]["count"].dtype == np.int32
    from repro_torch.launch import serve as pserve
    pserve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--device",
                 "cpu", "--ckpt", ck, "--requests", "1", "--prompt-len", "4",
                 "--new-tokens", "2", "--cache-len", "16"])
    assert "tok/s" in capsys.readouterr().out
