"""The port's examples (``examples/torch_*.py``) run on the CPU at a few
steps, each in a subprocess that must load no ``jax`` module and nothing of
the JAX package; their key printed lines are checked."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN = (
    "import runpy, sys\n"
    "sys.argv = {argv!r}\n"
    "try:\n"
    "    runpy.run_path({path!r}, run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    if e.code: raise\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
    "assert not bad, bad\n"
    "print('no jax loaded')\n")


def _run(name, *args):
    path = str(ROOT / "examples" / name)
    code = RUN.format(argv=[path, "--device", "cpu", *args], path=path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert out.stdout.rstrip().endswith("no jax loaded")
    return out.stdout


def test_quickstart_packed_forward_equals_qat():
    out = _run("torch_quickstart.py", "--steps", "16")
    err = float(re.search(r"kernel vs QAT max err: (\S+)", out).group(1))
    assert err < 1e-4
    assert re.search(r"PatternMatch: \d+ vectors, bpp=", out)
    assert re.search(r"packed size: \d+ bytes vs fp32 131072", out)


def test_serve_quantized_completes_every_request():
    out = _run("torch_serve_quantized.py", "--steps", "2")
    assert re.search(r"model bytes: fp32 [\d,]+ -> packed [\d,]+", out)
    done = re.findall(r"request (\d) \[length, \d+ steps in slot\]", out)
    assert sorted(done) == ["0", "1", "2", "3"]


def test_train_lm_runs_both_phases():
    out = _run("torch_train_lm_soniq.py", "--steps", "4", "--batch", "2",
               "--seq", "16")
    assert re.search(r"Phase I loss: +[\d.]+ -> [\d.]+", out)
    assert re.search(r"Phase II loss: [\d.]+ -> [\d.]+", out)
    assert re.search(r"deployed bpp: [\d.]+", out)
