#!/usr/bin/env python3
"""Registers, stack frame and spills of every instantiation of the port's
CUDA kernels, as ``nvcc -Xptxas -v`` reports them.

    python3 examples/torch_ptxas_report.py [source.cu[:KEY=V,...] ...]

Compiles each library (by default every one that chip_smoke.py's build
phase makes: #1 at its (n, m, e) and orders, #2 and #3 at its joint counts,
#4 and #5 at the classes it runs; or the sources named, each with the build
constants after its colon, e.g. ``riccati_small.cu:N=4,M=2,E=2,SO=0`` or
``flat_solve.cu:DYN=1,COST=1,E=0``) with the flags
of ``ddp_tpu_torch/kernels/_build.py`` plus ``-Xptxas -v``, one nvcc per
library, as many at once as the host has cores, and prints one line per
kernel instantiation: value type, template integers, registers, bytes of
stack frame, bytes of spill stores and loads, and the seconds nvcc took for
the library.  Needs nvcc, no card; the libraries it writes go to a
temporary directory.
"""

from __future__ import annotations

import os
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
    r"(?=(\d{1,2})(\w+_kernel)I([fd])((?:NS_\d+[A-Za-z_]\w*?I[fd](?:Li\d+E)*EE|L[ib]\d+E)+)E)"
)
ARG = re.compile(r"NS_(\d+)([A-Za-z_]\w*?)I([fd])((?:Li\d+E)*)EE|L([ib])(\d+)E")
SCALAR = {"f": "float", "d": "double"}


def describe(mangled: str) -> str:
    for m in MANGLED.finditer(mangled):
        if int(m.group(1)) != len(m.group(2)):
            continue
        shown = []
        for a in ARG.finditer(m.group(4)):
            if a.group(2):  # a problem-class policy struct, itself a template
                ints = "".join(f", {v}" for v in re.findall(r"Li(\d+)E", a.group(4)))
                shown.append(f"{a.group(2)}<{SCALAR[a.group(3)]}{ints}>")
            else:
                v = a.group(6)
                shown.append(v if a.group(5) == "i" else str(bool(int(v))).lower())
        return f"{m.group(2)}<{SCALAR[m.group(3)]}, {', '.join(shown)}>"
    return mangled


def libraries():
    """(source, build constants) of every library chip_smoke.py builds."""
    import chip_smoke as cs
    from ddp_tpu_torch.kernels import fd_derivs as fd
    from ddp_tpu_torch.kernels import riccati_small as rs

    out = [(rs.SOURCE, rs.instantiation(*shape)) for shape in cs.RICCATI_SHAPES]
    out += [(src, fd.instantiation(nv)) for src in ("fd_derivs.cu", "fd_derivs2.cu")
            for nv in cs.FD_JOINTS]  # fmt: skip
    return out + [(src, build) for src, names in (("linesearch_flat.cu", ("headline", "e0") + cs.FLAT_CLASSES),
                                                   ("flat_solve.cu", ("headline", "e0") + cs.FS_CLASSES))
                  for build in cs.flat_builds(names)]  # fmt: skip


def parse(arg: str):
    """``source.cu[:KEY=V,...]`` → (source, build constants or None)."""
    source, _, rest = arg.partition(":")
    consts = {k: int(v) for k, v in (kv.split("=") for kv in rest.split(",") if kv)}
    return source, consts or None


def report(source: str, consts, out_dir: str):
    out = Path(out_dir) / _build.library_path(source, consts).name
    nvcc, *args = _build.nvcc_command(source, consts, out)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, "-Xptxas", "-v", *args], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    name = out.name.rsplit("-", 1)[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    rows, entry, frame = [], None, None
    for line in proc.stderr.splitlines():
        if m := ENTRY.search(line):
            entry, frame = m.group(1), None
        elif m := FRAME.search(line):
            frame = m.groups()
        elif (m := REGS.search(line)) and entry:
            rows.append((describe(entry), m.group(1), *(frame or ("?",) * 3)))
            entry = None
    return name, seconds, rows


def main():
    libs = [parse(a) for a in sys.argv[1:]] or libraries()
    with tempfile.TemporaryDirectory() as out_dir, ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        for name, seconds, rows in pool.map(lambda lib: report(*lib, out_dir), libs):
            print(f"{name}: nvcc {seconds:.1f} s")
            for kernel, regs, frame, stores, loads in sorted(rows):
                print(f"  {kernel}: {regs} registers, {frame} B frame, "
                      f"{stores} B spill stores, {loads} B spill loads")  # fmt: skip


if __name__ == "__main__":
    main()
