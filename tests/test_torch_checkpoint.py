"""Checkpoint and restart in the JAX package's format, both ways, on the
CPU: the reference's own checkpoint cases (round trip, garbage
collection, the asynchronous save) on the port; a reduced h2o-danube-1.8b
QAT run checkpointed by one package and continued by the other, held
against the reference's uninterrupted run; NOISE (``s``) and
gradient-compression (``err``) states crossing both ways bitwise; and the
reference's kill-and-resume on the port's loop in a subprocess.

The reference's loop jits its steps with the abs-max scale divisions kept
true divisions (``_true_division``, as ``tests/test_torch_train.py``).
"""
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsynthetic
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import state as jstate

from repro_torch import interop
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import loop as ploop
from repro_torch.train import state as pstate

from test_torch_train import ARCH, SSM_ARCH, _abs_diffs, _configs, \
    _true_division

from test_torch_train import _one_thread  # noqa: F401

TK = dict(t1=0, t2=4, warmup=1, seed=3, checkpoint_every=2)


# ------------------------------------------------ the reference's cases ----
def test_checkpoint_roundtrip_and_gc(tmp_path):
    """The reference's ``test_checkpoint_roundtrip_and_gc`` on the port,
    with tensors (a None leaf stays None; ``keep`` bounds the steps)."""
    d = str(tmp_path / "ckpt")
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"mu": {"w": torch.ones((2, 3))}, "nu": {"w": None},
                     "count": np.asarray(5, np.int32)},
             "step": np.asarray(5, np.int32)}
    for s in (1, 2, 3, 4):
        pckpt.save(state, d, s, keep=2)
    assert pckpt.latest_step(d) == 4
    restored, step = pckpt.restore(d, state)
    assert step == 4
    np.testing.assert_array_equal(restored["params"]["w"],
                                  state["params"]["w"].numpy())
    assert restored["opt"]["nu"]["w"] is None
    assert restored["opt"]["count"].dtype == np.int32
    kept = [p for p in os.listdir(d) if p.startswith("step_")]
    assert len(kept) == 2
    with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 4 and man["none_leaves"] == ["opt/nu/w"]
    assert man["leaves"]["params/w"] == {"shape": [2, 3],
                                         "dtype": "float32"}


def test_checkpoint_async(tmp_path):
    """The reference's ``test_checkpoint_async`` on the port; the save
    copies its tensors before returning, so an in-place update right
    after it (the port's AdamW) does not reach the file."""
    d = str(tmp_path / "ckpt")
    w = torch.ones((4,))
    t = pckpt.async_save({"w": w}, d, 7)
    w.add_(1.0)
    t.join()
    restored, step = pckpt.restore(d, {"w": w})
    assert step == 7
    np.testing.assert_array_equal(restored["w"], np.ones((4,), np.float32))


def test_bf16_leaves_keep_the_reference_bytes(tmp_path):
    """bf16 moments are written as the reference's npz holds them (two
    raw bytes a value) and come back as the same bf16 tensor."""
    d = str(tmp_path / "ckpt")
    mu = torch.randn(5, 3).to(torch.bfloat16)
    pckpt.save({"mu": mu}, d, 1)
    with np.load(os.path.join(d, "step_00000001", "shard_0.npz")) as z:
        raw = z["mu"]
    want = np.asarray(jnp.asarray(mu.float().numpy()).astype(jnp.bfloat16))
    assert raw.dtype.itemsize == 2
    assert raw.tobytes() == want.tobytes()
    tree, _ = pckpt.restore(d)
    assert tree["mu"].dtype == torch.bfloat16 and torch.equal(tree["mu"], mu)


# ------------------------------------------------------- both ways, QAT ----
def _stream():
    jcfg, _ = _configs()
    return jsynthetic.TokenStream(jsynthetic.TokenStreamConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, batch_size=2,
        seed=2)).batches()


def _jax_train(ckpt_dir, batches):
    jcfg, _ = _configs()
    with _true_division():
        return jloop.train(jcfg.with_quant_mode("qat"), jstate.TrainConfig(
            ckpt_dir=ckpt_dir, **TK), batches)


def _step_dir(src, step, dst):
    """A checkpoint directory holding only ``src``'s step ``step``."""
    name = f"step_{step:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(dst, "LATEST"), "w") as f:
        f.write(str(step))
    return dst


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's uninterrupted 4 QAT steps, checkpointing at steps
    2 and 4."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    out = _jax_train(d, _stream())
    return d, out


def _assert_continues(history, params, ref):
    np.testing.assert_allclose([m["loss"] for m in history],
                               [m["loss"] for m in ref["history"][2:]],
                               rtol=1e-4, atol=1e-4)
    diffs = np.concatenate(_abs_diffs(params, jax.device_get(
        ref["state"]["params"])))
    assert diffs.max() <= 1e-4


def test_jax_checkpoint_continues_on_the_port(reference_run, tmp_path):
    """JAX -> port: the port restores the reference's step-2 checkpoint
    and trains steps 2-3 on their batches; losses and parameters within
    1e-4 of the reference's uninterrupted run."""
    src, ref = reference_run
    _, pcfg = _configs()
    d = _step_dir(src, 2, str(tmp_path / "ck"))
    pt = pstate.TrainConfig(ckpt_dir=d, **TK)
    out = ploop.train(pcfg, pt, itertools.islice(_stream(), 2, None),
                      device="cpu")
    assert [m["step"] for m in out["history"]] == [2, 3]
    assert out["state"]["step"] == 4 and out["state"]["opt"]["count"] == 4
    _assert_continues(out["history"],
                      interop.tree_to_numpy(out["state"]["model"]), ref)


def test_port_checkpoint_continues_on_jax(reference_run, tmp_path):
    """Port -> JAX: the port trains steps 0-1 from the reference's initial
    model and checkpoints; the reference's loop restores that and trains
    steps 2-3; losses and parameters within 1e-4 of the reference's
    uninterrupted run, which the port's own steps 0-1 also match."""
    src, ref = reference_run
    _, pcfg = _configs()
    tree0 = jax.device_get(jstate.init_state(
        jax.random.PRNGKey(TK["seed"]), _configs()[0].with_quant_mode("qat"),
        jstate.TrainConfig(**TK))["params"])
    pd = str(tmp_path / "port")
    losses = []
    with pytest.raises(StopIteration):     # fed steps 0-1 only
        ploop.train(pcfg.with_quant_mode("qat"), pstate.TrainConfig(
            ckpt_dir=pd, **TK), itertools.islice(_stream(), 2),
            device="cpu", model=interop.params_from_numpy(
                tree0, pcfg.with_quant_mode("qat"), "cpu"),
            hooks=[lambda step, _s, m: losses.append(m["loss"])])
    assert pckpt.latest_step(pd) == 2
    np.testing.assert_allclose(losses, [m["loss"] for m in
                                        ref["history"][:2]],
                               rtol=1e-4, atol=1e-4)
    out = _jax_train(pd, itertools.islice(_stream(), 2, None))
    assert [m["step"] for m in out["history"]] == [2, 3]
    _assert_continues(out["history"],
                      jax.device_get(out["state"]["params"]), ref)


# ------------------------------------------------- states, both ways ----
@pytest.mark.parametrize("mode,compress,arch", [
    ("noise", False, ARCH), ("qat", True, ARCH), ("noise", True, ARCH),
    ("noise", True, SSM_ARCH), ("qat", True, SSM_ARCH)],
    ids=["noise-False", "qat-True", "noise-True", "ssm-noise-True",
         "ssm-qat-True"])
def test_states_cross_both_ways_bitwise(mode, compress, arch, tmp_path):
    """A port state (random moments and, compressing, errors) saved by the
    port restores in the reference's ``restore`` with its ``init_state``
    as template, bit for bit; the reference saves what it restored, and
    the port restores it into the same state, bit for bit. On the SSM the
    mixer's fp leaves (``conv_w`` ... ``norm_g``), their moments and
    errors cross with its two linears, stacked under
    ``groups[0]["mamba"]``."""
    jcfg, pcfg = _configs(arch=arch)
    jcfg, pcfg = jcfg.with_quant_mode(mode), pcfg.with_quant_mode(mode)
    tk = dict(grad_compress=compress, t1=2, t2=4)
    pt = pstate.TrainConfig(**tk)
    st = pstate.init_state(pcfg, pt, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for tree in [st["opt"]["mu"], st["opt"]["nu"]] + (
            [st["err"]] if compress else []):
        for t in tree.values():
            t.copy_(torch.rand(t.shape, generator=gen))
    st["opt"]["count"], st["step"] = 3, 3
    pd = str(tmp_path / "port")
    pckpt.save(interop.state_to_tree(st), pd, 3)
    template = jstate.init_state(jax.random.PRNGKey(0), jcfg,
                                 jstate.TrainConfig(**tk))
    jrest, step = jckpt.restore(pd, template)
    assert step == 3 and ("err" in jrest) == compress
    want = interop.state_to_tree(st)
    jflat = jax.tree_util.tree_flatten_with_path(
        jrest, is_leaf=lambda x: x is None)[0]
    pflat = dict(jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: x is None)[0])
    assert len(jflat) == len(pflat)
    for path, leaf in jflat:
        if leaf is None:
            assert pflat[path] is None, path
            continue
        a, b = np.asarray(leaf), pflat[path]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    if compress and arch == ARCH:
        assert np.asarray(jrest["err"]["groups"][0]["attn"]["wq"]["w"]).any()
    elif compress:
        for leaf in ("conv_w", "dt_bias"):
            assert np.asarray(jrest["err"]["groups"][0]["mamba"][leaf]).any()
        assert np.asarray(jrest["opt"]["mu"]["groups"][0]["mamba"][
            "in_proj"]["w"]).any()
    jd = str(tmp_path / "jax")
    jckpt.save(jax.tree.map(jnp.asarray, jrest), jd, 3)
    back, _ = pckpt.restore(jd)
    again = interop.state_from_tree(back, pcfg, "cpu")
    assert again["step"] == 3 and again["opt"]["count"] == 3
    assert [n for n, _ in again["model"].named_parameters()] == \
        [n for n, _ in st["model"].named_parameters()]
    for (n, a), (_, b) in zip(st["model"].named_parameters(),
                              again["model"].named_parameters()):
        assert torch.equal(a, b), n
    for key in ("mu", "nu"):
        for n, t in st["opt"][key].items():
            assert torch.equal(t, again["opt"][key][n]), (key, n)
    if compress:
        for n, t in st["err"].items():
            assert torch.equal(t, again["err"][n]), n


# ------------------------------------------------------- kill and resume ----
SCRIPT = r"""
import json, sys
sys.path.insert(0, "src")
from repro_torch.configs.base import ArchConfig
from repro_torch.core.qtypes import QuantConfig
from repro_torch.data import synthetic
from repro_torch.train import loop, state as state_lib

ckpt, out, slow = sys.argv[1], sys.argv[2], sys.argv[3] == "slow"
cfg = ArchConfig(name="t", family="dense", num_layers=1, d_model=32,
                 num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
                 head_dim=16, dtype="float32", param_dtype="float32",
                 q_block=32, quant=QuantConfig(mode="qat"))
tcfg = state_lib.TrainConfig(t1=4, t2=14, warmup=1, checkpoint_every=2,
                             ckpt_dir=ckpt)
stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
    vocab_size=64, seq_len=16, batch_size=2))
def slow_hook(step, state, metrics):
    if slow:
        import time; time.sleep(0.4)
res = loop.train(cfg, tcfg, stream.batches(), hooks=[slow_hook],
                 device="cpu")
json.dump([h["step"] for h in res["history"]], open(out, "w"))
"""


def test_kill_and_resume(tmp_path):
    """The reference's ``tests/test_fault_tolerance.py`` on the port: a
    training subprocess killed (SIGKILL) after its step-4 checkpoint
    resumes from its newest checkpoint and finishes with a contiguous
    step history."""
    ckpt = str(tmp_path / "ckpt")
    out = str(tmp_path / "steps.json")
    script = str(tmp_path / "train.py")
    with open(script, "w") as f:
        f.write(SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src")
    p = subprocess.Popen([sys.executable, script, ckpt, out, "slow"],
                         env=env, cwd=root)
    deadline = time.time() + 60
    while time.time() < deadline:
        if os.path.exists(os.path.join(ckpt, "LATEST")):
            with open(os.path.join(ckpt, "LATEST")) as f:
                if int(f.read().strip() or 0) >= 4:
                    break
        time.sleep(0.1)
    p.send_signal(signal.SIGKILL)
    p.wait(timeout=30)
    assert not os.path.exists(out), "should have died before finishing"
    with open(os.path.join(ckpt, "LATEST")) as f:
        resumed_from = int(f.read().strip())
    assert resumed_from >= 4
    subprocess.run([sys.executable, script, ckpt, out, "fast"], env=env,
                   cwd=root, check=True, timeout=120)
    with open(out) as f:
        steps = json.load(f)
    assert steps == list(range(resumed_from, 14))
