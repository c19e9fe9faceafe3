"""One client that calls the route back to back, each call ending at the
device's synchronisation before the next is sent (a closed loop of one).

A mix file of this kind gives ``lanes`` (the batch of a call), ``pool``
(how many distinct batches are drawn from the seed in set-up and cycled)
and ``x0_low`` / ``x0_high`` (each state component of a lane's start drawn
uniformly between them)."""

from __future__ import annotations

import contextlib
import time

import torch


def make_inputs(mix: dict, seed: int, route, device) -> list:
    """The pool of start batches [lanes, nx] in the route's state size and
    type, made on the device from ``seed`` in one call."""
    nx, dtype = route.nx, route.dtype
    lo = torch.tensor(mix["x0_low"], dtype=dtype, device=device)
    hi = torch.tensor(mix["x0_high"], dtype=dtype, device=device)
    if lo.shape != (nx,) or hi.shape != (nx,):
        raise ValueError(f"x0_low and x0_high need {nx} values each")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((int(mix["pool"]), int(mix["lanes"]), nx), generator=gen, dtype=dtype, device=device)
    return list((lo + (hi - lo) * u).unbind(0))


def run(call, inputs, seconds, *, sync, on_result, span=None, route=None) -> dict:
    """Call ``call(inputs[i % len(inputs)])`` back to back until ``seconds``
    have passed since the first call started, each call timed from its entry
    to ``sync()``'s return; ``on_result(i, given, result)`` after each, with
    the input the call was given.  The route is not needed: a call's input
    does not depend on an earlier result.  Returns the calls' start and end
    times (host clock, seconds)."""
    span = span or contextlib.nullcontext
    starts, ends = [], []
    i = 0
    while True:
        x0 = inputs[i % len(inputs)]
        start = time.perf_counter()
        with span():
            result = call(x0)
            sync()
        end = time.perf_counter()
        starts.append(start)
        ends.append(end)
        on_result(i, x0, result)
        i += 1
        if end - starts[0] >= seconds:
            return dict(starts=starts, ends=ends)
