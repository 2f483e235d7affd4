"""Build the port's CUDA kernels with ``nvcc`` into plain-C shared
libraries and load them with ``ctypes``.

Each source under ``repro_torch/csrc`` compiles on its own (one ``nvcc``
per source, all started together) for ``sm_90a``, at first use, into
``repro_torch/_build/<stem>-<hash>.so``; the hash covers the source and
the flags, so an edited source rebuilds and an unchanged one is reused.
The build writes to a temporary file and renames it into place, so
concurrent processes never load a half-written library. ``ptxas -v``
output (registers, shared memory, spills) is kept beside each library.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("segment_gemm.cu", "quant_pack.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 900

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA kernels are built on the machine with the card")


def target(source: str) -> Path:
    """The cached library path of one source."""
    digest = hashlib.sha256()
    digest.update((CSRC / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose cached library is missing, all in
    parallel. Returns {source: seconds} for the ones compiled; raises
    ``RuntimeError`` with nvcc's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for source in sources:
        out = target(source)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[source] = (proc, tmp, out, time.perf_counter())
    seconds = {}
    failures = []
    for source, (proc, tmp, out, t0) in running.items():
        try:
            text, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            failures.append(f"{source}: nvcc timed out\n{text}")
            continue
        if proc.returncode:
            failures.append(f"{source}: nvcc exit {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".ptxas.txt").write_text(text)
        os.replace(tmp, out)
        seconds[source] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def ptxas_report(source: str) -> Optional[str]:
    """``nvcc -Xptxas -v`` output of the cached build of ``source``."""
    path = target(source).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else None


def library(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use); ``bind``
    declares the argtypes/restype of its entry points once."""
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(target(source)))
        bind(lib)
        _LIBS[source] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a kernel entry returned a CUDA error code."""
    if code:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
