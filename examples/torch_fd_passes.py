#!/usr/bin/env python3
"""Device time of each pass of the fd-derivatives kernel (``csrc/fd_derivs.cu``:
the primal pass, the q pass and the v pass), on one CUDA card.

    python3 examples/torch_fd_passes.py

Calls ``kernels.fd_derivs.fd_derivs`` on chip_smoke.py's panda7 inputs
(N = 4096, f32 and f64) once to warm up and five times under
``torch.profiler``, and prints per device kernel its mean time a call, its
share of the call and its launches, and the whole call's time by CUDA events
(median of 20).  Needs a card and nvcc.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ddp_tpu_torch.kernels import fd_derivs as fd  # noqa: E402
from ddp_tpu_torch.models import robots  # noqa: E402

CALLS = 5


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(card, flush=True)
    N = cs.ARM_B * cs.ARM_H
    for dtype in (torch.float32, torch.float64):
        model = robots.panda7(device=cs.DEV, dtype=dtype)
        inputs = cs.fd_inputs(model, N, dtype)
        fd.fd_derivs(model, *inputs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fd.fd_derivs(model, *inputs)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if "fd_" in e.key and "_kernel" in e.key]
        total = sum(e.self_device_time_total for e in rows)
        for e in sorted(rows, key=lambda e: -e.self_device_time_total):
            name = e.key[e.key.index("fd_"):].split("<")[0].split("(")[0]
            print(f"[fd_pass] card='{card}' dtype={str(dtype)[6:]} N={N} kernel={name} "
                  f"ms_per_call={e.self_device_time_total / 1e3 / CALLS:.4f} "
                  f"share={e.self_device_time_total / total:.3f} launches={e.count}",
                  flush=True)  # fmt: skip
        call_ms = cs.event_ms(lambda: fd.fd_derivs(model, *inputs))
        print(f"[fd_call] card='{card}' dtype={str(dtype)[6:]} N={N} call_ms={call_ms:.4f}",
              flush=True)  # fmt: skip


if __name__ == "__main__":
    main()
