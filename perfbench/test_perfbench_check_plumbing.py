"""The check's plumbing on the CPU, without a run: the comparison takes the
reference the route names and reads what it returns, a call's input is
what the traffic gave the call (any pytree of batch-first tensors, joined
leaf by leaf), and the closed-loop traffic hands the harness the very
tensor each call was given.

    python -m pytest perfbench/test_perfbench_check_plumbing.py -q
"""

from __future__ import annotations

import hashlib
import math
import types
from typing import NamedTuple

import pytest
import torch
from torch.utils._pytree import tree_leaves

from perfbench import run
from perfbench.reference import compare, flat_al_ddp

# compare.judge(cfg, x0s, got) on the case below, read before the
# reference became an argument: the check's numbers and its per-field record
NUMBERS = {
    "lanes_apart": 0.25, "gap_median": 0.00011102633212480967, "sensitive_median": 0.00011149673947651476,
    "rollout_residual": 0.09963441185657602, "constr_residual": 0.045721821040923594,
}  # fmt: skip
PER_FIELD = {
    "us": {"apart": 0.25, "median": 9.442289625667417e-05, "max": 0.06183420447343865},
    "xs": {"apart": 0.25, "median": 8.665663498759372e-05, "max": 0.06584493077148246},
    "mult_origin": {"apart": 0.25, "median": 7.646353021310373e-05, "max": 0.05917847446048405},
    "fb_K": {"apart": 0.21875, "median": 3.4362527008668205e-05, "max": 0.03730355586954883},
    "mult_jac": {"apart": 0.1875, "median": 8.801359055891256e-05, "max": 0.08953958263758487},
    "fb_k": {"apart": 0.125, "median": 5.0361771096329415e-05, "max": 0.030312089316729046},
    "mult_val": {"apart": 0.15625, "median": 1.1844972675909894e-05, "max": 0.042008921842616745},
    "opt_constr": {"apart": 0.0, "median": 2.0132211453471882e-07, "max": 0.00040960486242802574},
    "opt_lag": {"apart": 0.15625, "median": 5.052547613104242e-05, "max": 0.02096483202006424},
    "w": {"apart": 0.0, "median": 1.415800705372714e-28, "max": 9.663254916867838e-25},
    "n": {"apart": 0.21875, "median": 3.4145302417939025e-05, "max": 0.03812495176680394},
    "mu": {"apart": 0.09375, "median": 7.096e-05, "max": 0.040815936},
    "reg": {"apart": 0.0, "median": 0.0, "max": 0.0},
}  # fmt: skip
# sha256 of closed_loop.b4096's pool for seed 2**31 + 23 (float32, CPU) as
# the generator drew it when it was given the state size and type alone
POOL_DIGEST = "4b79f7eca39617e8754d831b0d53ac8fd261937468b784926457484ee604b261"


def swingup_case():
    """pendulum_swingup_t32 at 32 lanes: seeded float32 starts, and as the
    program's results the reference's own f64 fields, each lane's entries
    moved by a relative 1e-6 to 1e-1 of seeded noise, in float32."""
    cfg = run.load_json("configs", "pendulum_swingup_t32.json")
    gen = torch.Generator().manual_seed(2**31 + 21)
    q = (2 * torch.rand(32, generator=gen, dtype=torch.float64) - 1) * math.pi
    x0s = torch.stack([q, torch.zeros_like(q)], 1).to(torch.float32)
    ref = flat_al_ddp.solve(cfg, x0s, torch.float64)
    lane_eps = 10.0 ** (-6 + 5 * torch.rand(32, generator=gen, dtype=torch.float64))
    got = {}
    for k in sorted(ref):
        v = ref[k]
        eps = lane_eps.reshape((32,) + (1,) * (v.dim() - 1))
        got[k] = (v * (1 + eps * torch.randn(v.shape, generator=gen, dtype=torch.float64))).to(torch.float32)
    return cfg, x0s, got


def test_judge_with_the_routes_reference_reads_as_before():
    """The comparison given the route's reference module reads every number
    and every field's record exactly as it did when it imported it."""
    assert run.load_module("routes", "solve_flat").REFERENCE == "flat_al_ddp"
    cfg, x0s, got = swingup_case()
    ref = run.load_module("reference", "flat_al_ddp")
    numbers, per_field = compare.judge(ref, cfg, x0s, got)
    assert numbers == NUMBERS
    assert per_field == PER_FIELD


class Carry(NamedTuple):
    us: torch.Tensor  # [B, T, 1]
    mu: torch.Tensor  # [B]


class Stub:
    """A reference of its own: x' = x + u over T = 4 steps, the constraint
    x_T = 0, solved by u_t = -x0 / 4 (exact in binary).  A call's input is a
    start batch [B, 1] or a (state [B, 1], Carry) pair; ``seen`` records
    every input its solve is given."""

    TYPES = {"float64": torch.float64}
    T = 4

    class Recipe:
        def __init__(self, cfg):
            self.w_min, self.threshold = 1e-6, 1e-6
            self.mu0, self.reg0, self.w0, self.n0 = 1.0, 0.0, 1.0, 1.0

    def __init__(self):
        self.seen = []

    @staticmethod
    def starts(inputs):
        return tree_leaves(inputs)[0]

    @staticmethod
    def dynamics(r, xs, us):
        return xs + us

    def rollout(self, r, inputs, us):
        xs = [self.starts(inputs).to(us.dtype)]
        for t in range(us.shape[1]):
            xs.append(self.dynamics(r, xs[-1], us[:, t]))
        return torch.stack(xs, 1)

    @staticmethod
    def final_eq(r, xs, us):
        return xs[:, -1]

    def solve(self, cfg, inputs, dtype):
        self.seen.append(inputs)
        r = self.Recipe(cfg)
        x0 = self.starts(inputs).to(dtype)
        B = x0.shape[0]
        us = (-x0 / self.T)[:, None, :].expand(B, self.T, 1).clone()
        xs = self.rollout(r, x0, us)
        zeros = torch.zeros((B, self.T, 1), dtype=dtype)
        lane = torch.zeros(B, dtype=dtype)
        return dict(
            us=us, xs=xs, fb_k=zeros, fb_K=zeros[..., None], mult_val=zeros, mult_jac=zeros[..., None],
            mult_origin=xs[:, : self.T], opt_constr=torch.linalg.vector_norm(self.final_eq(r, xs, us), dim=-1),
            opt_lag=lane, mu=lane + r.mu0, reg=lane, w=lane + r.w0, n=lane + r.n0,
        )  # fmt: skip


STUB_CFG = dict(feasible_below=1e-2)


def test_the_given_reference_decides_the_numbers():
    """The stub's own answers with one control moved by 1 on the first
    quarter of the lanes: exactly that quarter reads apart, and nothing else
    differs but the moved lanes' rollout."""
    stub = Stub()
    x0s = 2 * torch.rand((32, 1), generator=torch.Generator().manual_seed(2**31 + 3), dtype=torch.float64) - 1
    got = stub.solve(STUB_CFG, x0s, torch.float64)
    got["us"] = got["us"].clone()
    got["us"][:8, 0] += 1.0
    stub.seen.clear()
    numbers, per_field = compare.judge(stub, STUB_CFG, x0s, got)
    assert numbers["lanes_apart"] == 0.25 and per_field["us"]["apart"] == 0.25
    assert numbers["gap_median"] == numbers["sensitive_median"] == numbers["constr_residual"] == 0.0
    assert numbers["rollout_residual"] == pytest.approx(1.0, rel=1e-12)
    assert all(f["apart"] == 0.0 for name, f in per_field.items() if name != "us")
    assert len(stub.seen) == 1 and torch.equal(stub.seen[0], x0s)


@pytest.mark.parametrize("calls", ["two", "drawn_is_last"])
def test_state_and_carry_reach_the_reference_joined_in_call_order(calls, monkeypatch):
    """Calls given (state, Carry) pairs, each leaf filled with its call's
    index: the compared calls' inputs reach the stub's solve joined leaf by
    leaf, the drawn call's lanes before the last's, the carry still a
    Carry; with a block of one call's lanes, one solve a call."""
    B, stub = 8, Stub()
    compared = run.Compared(2**31 + 9)
    k = compared.drawn
    n = k + 1 if calls == "drawn_is_last" else k + 5
    for i in range(n):
        carry = Carry(torch.full((B, 4, 1), 100.0 + i), torch.full((B,), 1000.0 + i))
        given = (torch.full((B, 1), float(i)), carry)
        compared.add(i, given, stub.solve(STUB_CFG, given, torch.float32))
    stub.seen.clear()
    inputs, got = compared.joined(lambda result: result)
    order = [k] if calls == "drawn_is_last" else [k, n - 1]
    monkeypatch.setattr(compare, "BLOCK", B)
    numbers, _ = compare.judge(stub, STUB_CFG, inputs, got)
    assert numbers["lanes_apart"] == 0.0 and numbers["rollout_residual"] == 0.0
    assert len(stub.seen) == len(order)
    for seen, i in zip(stub.seen, order):
        state, carry = seen
        assert isinstance(carry, Carry)
        assert torch.equal(state, torch.full((B, 1), float(i)))
        assert torch.equal(carry.us, torch.full((B, 4, 1), 100.0 + i))
        assert torch.equal(carry.mu, torch.full((B,), 1000.0 + i))
    assert torch.equal(got["xs"][:, 0, 0], torch.tensor(order, dtype=torch.float32).repeat_interleave(B))


def test_closed_loop_gives_the_called_tensor_and_the_parents_pool():
    """The pool from a seed is the one drawn before the generator was given
    the route, and ``on_result`` receives the very tensor each call got
    (21 calls: the pool cycled past its 16 batches)."""
    traffic = run.load_module("traffic", "closed_loop")
    mix = run.load_json("traffic", "closed_loop.b4096.json")
    route = types.SimpleNamespace(nx=2, dtype=torch.float32)
    pool = traffic.make_inputs(mix, 2**31 + 23, route, torch.device("cpu"))
    assert hashlib.sha256(torch.stack(pool).numpy().tobytes()).hexdigest() == POOL_DIGEST
    ticks = iter(range(10**6))
    traffic.time = types.SimpleNamespace(perf_counter=lambda: float(next(ticks)))  # each call lasts one tick
    called, handed = [], []
    window = traffic.run(lambda x0: called.append(x0) or len(called), pool, 41.0, sync=lambda: None,
                         on_result=lambda i, given, result: handed.append((i, given, result)), route=route)  # fmt: skip
    assert len(window["starts"]) == len(called) == len(handed) == 21
    for i, (j, given, result) in enumerate(handed):
        assert j == i and result == i + 1
        assert given is called[i] and given is pool[i % len(pool)]
