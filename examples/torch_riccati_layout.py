#!/usr/bin/env python3
"""The small-dims program of the Riccati ladder kernel reading batch-major
inputs (as it ships) against the same program reading the batch-last layout
of ``riccati_small.pack_batch_last``, on one CUDA card.

    python3 examples/torch_riccati_layout.py

Builds ``csrc/riccati_small.cu`` as it is and a copy whose small-dims
program indexes its inputs [T, rows, B] (one line changed; nvcc with
``kernels/_build.py``'s flags and each shape's defines into a temporary
directory), then at the
small-dims shapes of chip_smoke.py — (2, 1, 1) at B=4096, T=32, one level,
Gauss-Newton and second order, and (4, 2, 2) second order at B=1000, T=16,
four levels, in f32 — times one launch of each on the same inputs (CUDA
events, median of 20, in the order batch-major, batch-last, batch-last,
batch-major), checks that both give the same bits, and times the packing
that the batch-last program would need on top (``pack_batch_last``).
Needs nvcc and a card.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ddp_tpu_torch.kernels import _build  # noqa: E402
from ddp_tpu_torch.kernels import riccati_small as rs  # noqa: E402
from ddp_tpu_torch.solver.batched import _reg_levels  # noqa: E402

BATCH_MAJOR = "      return p[(static_cast<size_t>(b) * T + t) * rows + r];"
BATCH_LAST = "      return p[(static_cast<size_t>(t) * rows + r) * Bs + b];"


def build_batch_last(out_dir: Path, consts: dict):
    """The batch-last copy of the source, built for the shape ``consts``."""
    src = (_build.CSRC / rs.SOURCE).read_text()
    if src.count(BATCH_MAJOR) != 1:
        raise RuntimeError("the small-dims program's input indexing is not where this script expects it")
    copy = out_dir / rs.SOURCE
    copy.write_text(src.replace(BATCH_MAJOR, BATCH_LAST))
    lib = _build.library_path(rs.SOURCE, consts)
    lib = out_dir / f"batch_last_{lib.name}"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *_build.defines(consts), f"-I{_build.CSRC}",
                    "-o", str(lib), str(copy)], check=True, capture_output=True, text=True)  # fmt: skip
    fn = ctypes.CDLL(str(lib)).ddp_riccati_ladder
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, plan):
    ptrs = (ctypes.c_void_p * len(plan.inputs))(*[0 if x is None else x.data_ptr() for x in plan.inputs])
    tail = [x.data_ptr() for x in plan.scratch + plan.outputs]
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        rc = fn(*plan.ints, ctypes.cast(ptrs, ctypes.c_void_p), *tail, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")

    return go


def batch_last_plan(plan, derivs, mult_val, mult_jac, second_order):
    """``plan`` with its per-step inputs replaced by the batch-last arrays
    and fresh outputs."""
    packed = rs.pack_batch_last(derivs, mult_val, mult_jac, second_order=second_order)
    names = rs._INPUTS + rs._INPUTS_SECOND_ORDER
    inputs = tuple(packed[k] if k in packed and i < len(names) else x
                   for i, (k, x) in enumerate(zip(names + ("mu", "levels", "lfx", "lfxx"), plan.inputs)))  # fmt: skip
    return plan._replace(inputs=inputs, outputs=tuple(torch.empty_like(x) for x in plan.outputs))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cases = (
            ("n2m1e1_gn_B4096_T32_L1", cs.pendulum_inputs(cs.B, torch.float32), 1, False),
            ("n2m1e1_so_B4096_T32_L1",
             cs.spd_inputs(cs.B, cs.T, 2, 1, 1, torch.float32, second_order=True), 1, True),
            ("n4m2e2_so_B1000_T16_L4",
             cs.spd_inputs(1000, 16, 4, 2, 2, torch.float32, second_order=True), 4, True),
        )  # fmt: skip
        for label, (inputs, mu, reg), n_levels, so in cases:
            levels = torch.stack(_reg_levels(mu, reg, n_levels))
            plan = rs.plan_launch(*inputs, mu, levels, so)
            shape = plan.ints[2:5]
            last_fn = build_batch_last(Path(tmp), rs.instantiation(*shape, so))
            major_fn = rs._kernel_fn(*shape, so)
            plan_bl = batch_last_plan(plan, *inputs, so)
            run_major, run_last = launcher(major_fn, plan), launcher(last_fn, plan_bl)
            run_major()
            run_last()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(plan.outputs, plan_bl.outputs))
            times = {"major": [], "last": []}
            for which in ("major", "last", "last", "major"):
                times[which].append(cs.event_ms(run_major if which == "major" else run_last))
            pack_ms = cs.event_ms(lambda: rs.pack_batch_last(*inputs, second_order=so))
            print(f"[riccati_layout] card='{card}' shape={label}_f32 "
                  f"batch_major_ms={[f'{x:.4f}' for x in times['major']]} "
                  f"batch_last_ms={[f'{x:.4f}' for x in times['last']]} "
                  f"pack_batch_last_ms={pack_ms:.4f} same_bits={same}", flush=True)  # fmt: skip
            if not same:
                raise RuntimeError(f"{label}: the two layouts disagree")


if __name__ == "__main__":
    main()
