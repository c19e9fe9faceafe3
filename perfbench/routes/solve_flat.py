"""The entry point ``ddp_tpu_torch.kernels.flat_solve.solve_flat``: the whole
fixed-budget solve of a flat-lane problem in one launch (``csrc/flat_solve.cu``
on CUDA tensors, its plain version on CPU tensors).  The only module of the
benchmark that imports the program."""

from __future__ import annotations

import torch

from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels import flat_solve
from ddp_tpu_torch.solver.solve import Method, SolverParams

COUNTS = "flat_solve"  # perfbench/counts/<COUNTS>.py
REFERENCE = "flat_al_ddp"  # perfbench/reference/<REFERENCE>.py, the check's plain reference
_PARAMS = SolverParams._fields


class Route:
    """One configuration's problem and solver settings on ``device``."""

    def __init__(self, cfg: dict, device):
        self.dtype = {"float32": torch.float32, "float64": torch.float64}[cfg["dtype"]]
        self.problem = problem_from_numpy(cfg, device=device, dtype=self.dtype)
        self.params = SolverParams(**{k: cfg[k] for k in _PARAMS if k in cfg})
        self.method = Method(cfg["method"])
        self.n_linesearch = int(cfg["n_linesearch"])
        self.nx = self.problem.nx
        self.feasible_below = float(cfg["feasible_below"])

    def call(self, x0s):
        """One solve of the batch x0s [B, nx] from zero controls (no sync)."""
        return flat_solve.solve_flat(self.problem, self.params, x0s, method=self.method,
                                     n_linesearch=self.n_linesearch)  # fmt: skip

    @staticmethod
    def fields(result) -> dict:
        """The result's fields by name (views, no copies), batch-major."""
        if isinstance(result, dict):
            return result
        return dict(
            us=result.us, xs=result.xs, fb_k=result.fb_k, fb_K=result.fb_K,
            mult_val=result.mults.val, mult_jac=result.mults.jac, mult_origin=result.mults.origin,
            opt_constr=result.opt_constr, opt_lag=result.opt_lag, mu=result.mu, reg=result.reg,
            w=result.w, n=result.n,
        )  # fmt: skip

    def tally(self, lanes: int, device) -> "Tally":
        """The window's counter of feasible and non-finite lanes."""
        return Tally(lanes, self.feasible_below, dtype=self.dtype, device=device)

    def describe(self, x0s) -> dict:
        """What the program says of a call at this batch: its launch plan
        (program, lanes an SM, waves) on a card."""
        plan = flat_solve.plan_launch(self.problem, self.params, x0s, method=self.method,
                                      n_linesearch=self.n_linesearch)  # fmt: skip
        return dict(plan=plan.geometry or "not available")

    @staticmethod
    def launches() -> int:
        return flat_solve.LAUNCHES


class Tally:
    """Counts, on the device, the lanes whose result is feasible and those
    whose result is not finite, with one launch a call: each lane's
    opt_constr plus 0 × its final state (non-finite where any control or
    state of the lane is, since every step feeds the next) goes into a ring
    of ``SLOTS`` rows, reduced when it is full and at the end."""

    SLOTS = 64

    def __init__(self, lanes: int, feasible_below: float, **kw):
        self.limit = feasible_below
        self.ring = torch.zeros((self.SLOTS, lanes, 2), **kw)
        self.rows = self.ring.unbind(0)  # made once: a call costs one launch
        self.zero = torch.zeros((), **kw)
        self.acc = torch.zeros(2, dtype=torch.int64, device=kw["device"])
        self.used = 0

    def add(self, fields: dict):
        last = fields["xs"].select(1, -1)
        torch.addcmul(fields["opt_constr"].unsqueeze(1), last, self.zero, out=self.rows[self.used])
        self.used += 1
        if self.used == self.SLOTS:
            self._flush()

    def _flush(self):
        ring = self.ring[: self.used]
        finite = torch.isfinite(ring).all(-1)
        self.acc += torch.stack([(finite & (ring[..., 0] < self.limit)).sum(), (~finite).sum()])
        self.used = 0

    def read(self) -> tuple[int, int]:
        """(feasible lanes, lanes with a non-finite result) so far (syncs)."""
        if self.used:
            self._flush()
        feasible, nonfinite = self.acc.tolist()
        return int(feasible), int(nonfinite)
