#!/usr/bin/env python3
"""Registers, stack frame and spills of every instantiation of the port's
CUDA kernels, as ``nvcc -Xptxas -v`` reports them.

    python3 examples/torch_ptxas_report.py [source.cu ...]

Compiles each source of ``ddp_tpu_torch/csrc/`` (all of them by default) with
the flags of ``ddp_tpu_torch/kernels/_build.py`` plus ``-Xptxas -v``, one
nvcc per source, all at once, and prints one line per kernel instantiation:
value type, template integers, registers, bytes of stack frame, bytes of
spill stores and loads, and the seconds nvcc took for the file.  Needs nvcc,
no card; the libraries it writes go to a temporary directory.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ddp_tpu_torch.kernels import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")
# the Itanium mangling of `name<float|double, [policy<float|double>,] ints...,
# bools...>` (as a lookahead, so that every start position is tried: the
# length prefix must equal the name's length)
MANGLED = re.compile(
    r"(?=(\d{1,2})(\w+_kernel)I([fd])((?:NS_\d+[A-Za-z_]\w*?I[fd]EE|L[ib]\d+E)+)E)"
)
ARG = re.compile(r"NS_(\d+)([A-Za-z_]\w*?)I([fd])EE|L([ib])(\d+)E")
SCALAR = {"f": "float", "d": "double"}


def describe(mangled: str) -> str:
    for m in MANGLED.finditer(mangled):
        if int(m.group(1)) != len(m.group(2)):
            continue
        shown = []
        for a in ARG.finditer(m.group(4)):
            if a.group(2):  # a problem-class policy struct, itself a template
                shown.append(f"{a.group(2)}<{SCALAR[a.group(3)]}>")
            else:
                v = a.group(5)
                shown.append(v if a.group(4) == "i" else str(bool(int(v))).lower())
        return f"{m.group(2)}<{SCALAR[m.group(3)]}, {', '.join(shown)}>"
    return mangled


def report(source: str, out_dir: str):
    src = _build.CSRC / source
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-o", str(Path(out_dir) / (src.stem + ".so")), str(src)],
        capture_output=True, text=True,
    )  # fmt: skip
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    rows, entry, frame = [], None, None
    for line in proc.stderr.splitlines():
        if m := ENTRY.search(line):
            entry, frame = m.group(1), None
        elif m := FRAME.search(line):
            frame = m.groups()
        elif (m := REGS.search(line)) and entry:
            rows.append((describe(entry), m.group(1), *(frame or ("?",) * 3)))
            entry = None
    return source, seconds, rows


def main():
    sources = sys.argv[1:] or sorted(p.name for p in _build.CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory() as out_dir, ThreadPoolExecutor(len(sources)) as pool:
        for source, seconds, rows in pool.map(lambda s: report(s, out_dir), sources):
            print(f"{source}: nvcc {seconds:.1f} s")
            for name, regs, frame, stores, loads in sorted(rows):
                print(f"  {name}: {regs} registers, {frame} B frame, "
                      f"{stores} B spill stores, {loads} B spill loads")  # fmt: skip


if __name__ == "__main__":
    main()
