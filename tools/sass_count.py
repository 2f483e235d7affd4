"""Count the SASS instructions of a built kernel's main loop per element.

    python3 tools/sass_count.py LIB.so KERNEL ELEMENTS_PER_PASS

``cuobjdump -sass`` of the library (the CUDA toolkit's, from PATH or
``/usr/local/cuda/bin``) lists each template instance of ``KERNEL``. Its
main loop is the longest backward branch (a span of the listing that ends
in a ``BRA`` to an earlier address); its static instruction count, NOPs
left out, over the elements one pass of that loop computes is the count
per element. It is a static count: a predicated instruction counts once,
and a call out of the loop (a slow path) counts as one instruction.

The kernel's instances are tagged by their template arguments as the
mangled name carries them: the element type (``f32`` or ``bf16``) and
the integer or boolean arguments in order.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16"}


def cuobjdump() -> Optional[str]:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    return str(default) if default.exists() else None


def functions(sass: str) -> Dict[str, List[Tuple[int, str]]]:
    """{mangled name: [(address, instruction)]} of a ``cuobjdump -sass``
    listing, with each branch's label resolved to an address."""
    out: Dict[str, List[Tuple[int, str]]] = {}
    name, body, labels, pending = None, [], {}, []
    for line in sass.splitlines() + ["Function : <end>"]:
        if "Function :" in line:
            if name is not None:
                out[name] = [(a, _resolve(t, labels)) for a, t in body]
            name, body, labels, pending = line.split(":", 1)[1].strip(), \
                [], {}, []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _ADDR.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            body.append((addr, m.group(2)))
    return out


def _resolve(text: str, labels: Dict[str, int]) -> str:
    m = _TARGET.search(text)
    if m and m.group(1):
        return text.replace(f"`({m.group(1)})",
                            hex(labels.get(m.group(1), -1)))
    return text


def main_loop(body: List[Tuple[int, str]]) -> Tuple[int, int]:
    """(instructions in the longest backward-branch span, in the whole
    function), NOPs left out."""
    def count(lo, hi):
        return sum(1 for a, t in body if lo <= a <= hi
                   and not t.startswith("NOP"))
    best = 0
    for addr, text in body:
        m = _TARGET.search(text)
        if m and m.group(2):
            target = int(m.group(2), 16)
            if 0 <= target <= addr:
                best = max(best, count(target, addr))
    return best, count(0, 1 << 62)


def tag(name: str, kernel: str) -> Optional[str]:
    """``f32/1/0/16/1``-style tag of an instance of ``kernel``, or None."""
    m = re.search(re.escape(kernel) + r"I(f|13__nv_bfloat16)((?:L[bi]\d+E)*)",
                  name)
    if not m:
        return None
    args = re.findall(r"L[bi](\d+)E", m.group(2))
    return "/".join([_TYPES[m.group(1)]] + args)


def kernel_counts(lib: str, kernel: str, per_pass) -> Dict[str, Dict]:
    """{instance tag: {"loop": n, "static": n, "per_element": n / e}} for
    every instance of ``kernel`` in ``lib``; ``per_pass(dtype)`` gives the
    elements one pass of the main loop computes for ``f32`` or ``bf16``."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found (PATH or /usr/local/cuda/bin)")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for name, body in functions(sass).items():
        t = tag(name, kernel)
        if t is None or "bwd" in name:
            continue
        loop, static = main_loop(body)
        out[t] = {"loop": loop, "static": static,
                  "per_element": round(loop / per_pass(t.split("/")[0]), 2)}
    return dict(sorted(out.items()))


def ptxas_lines(report: str, kernel: str) -> Dict[str, str]:
    """{instance tag: its "Used ..." and spill lines} from ``nvcc -Xptxas
    -v`` output, for every instance of ``kernel``."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = tag(line, kernel)
        elif name and ("spill" in line or "Used" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1]
                         .strip()).strip()
    return dict(sorted(out.items()))


def fake_quant_per_pass(source_text: str):
    """Elements one pass of B8's forward loop computes, from its source:
    ROWS 16-byte vectors where the source declares ROWS, else VEC
    elements (one row's vector)."""
    rows = re.search(r"constexpr int ROWS = (\d+);", source_text)
    vec = re.search(r"constexpr int VEC = (\d+);", source_text)

    def per_pass(dtype):
        if rows:
            return int(rows.group(1)) * (4 if dtype == "f32" else 8)
        return int(vec.group(1))
    return per_pass


if __name__ == "__main__":
    lib_path, kern, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
    for k, v in kernel_counts(lib_path, kern, lambda _d: n).items():
        print(k, v)
