"""The port stands alone: no module of ``repro_torch`` imports jax or the
JAX package, and every TPU kernel of the JAX package is either mapped to a
port kernel or queued in ROADMAP.md §B."""
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch
from repro.analysis import kernel_audit

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(repro_torch.__file__).resolve().parent

# TPU kernel entry (module, function) -> the port's wrapper, as
# "module:function" under repro_torch.
PORTED = {
    ("repro.kernels.packed_matmul", "fused_act_segment_matmul"):
        "repro_torch.kernels.packed_matmul:fused_act_segment_matmul",
    ("repro.kernels.packed_matmul", "fused_act_selfscale_matmul"):
        "repro_torch.kernels.packed_matmul:fused_act_selfscale_matmul",
    ("repro.kernels.packed_matmul", "packed_segment_matmul"):
        "repro_torch.kernels.packed_matmul:packed_segment_matmul",
    ("repro.kernels.packed_matmul", "packed_segment_matmul_grouped"):
        "repro_torch.kernels.packed_matmul:packed_segment_matmul_grouped",
    ("repro.kernels.quant_pack", "quantize_pack"):
        "repro_torch.kernels.quant_pack:quantize_pack",
    ("repro.kernels.attn_decode", "qkv_attn_decode"):
        "repro_torch.kernels.attn_decode:qkv_attn_decode",
    ("repro.kernels.attn_decode", "qkv_attn_decode_paged"):
        "repro_torch.kernels.attn_decode:qkv_attn_decode_paged",
    ("repro.kernels.noise_inject", "noise_inject"):
        "repro_torch.kernels.noise_inject:noise_inject",
    ("repro.kernels.fake_quant", "fake_quant"):
        "repro_torch.kernels.fake_quant:fake_quant",
}
# The CUDA source behind each ported wrapper.
SOURCES = {"packed_matmul": "segment_gemm.cu", "quant_pack": "quant_pack.cu",
           "attn_decode": "attn_decode.cu",
           "noise_inject": "noise_inject.cu", "fake_quant": "fake_quant.cu"}


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="repro_torch."))


def test_importing_the_port_pulls_in_no_jax():
    mods = _port_modules()
    assert "repro_torch.serve.engine" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), _FORBIDDEN.search(text).group(0)


def _roadmap_queue() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("### B.")
    return text[start:text.index("\n### ", start + 1)]


@pytest.mark.parametrize("entry", kernel_audit.MANIFEST,
                         ids=lambda e: e.where)
def test_every_tpu_kernel_is_ported_or_queued(entry):
    target = PORTED.get((entry.module, entry.func))
    if target is None:
        assert f"`{entry.func}`" in _roadmap_queue() or \
            f"::{entry.func}`" in _roadmap_queue(), \
            f"{entry.where} is neither ported nor queued in ROADMAP.md §B"
        return
    mod, fn = target.split(":")
    assert callable(getattr(importlib.import_module(mod), fn))
    src = PORT / "csrc" / SOURCES[mod.rsplit(".", 1)[-1]]
    assert src.exists()
    # The source note names the TPU kernel it replaces.
    assert f"src/repro/kernels/{entry.module.rsplit('.', 1)[-1]}.py" \
        in src.read_text()
