"""ddp_tpu_torch: the PyTorch + CUDA port of ``ddp_tpu``.

Mirrors ``ddp_tpu``'s layout (``models/``, ``ocp/``, ``solver/``,
``kernels/``) so each counterpart is easy to find; CUDA sources live in
``csrc/`` and are compiled at first CUDA use, never on import.  The package
imports torch and numpy only — never JAX.
"""

from ddp_tpu_torch.models import pendulum
from ddp_tpu_torch.solver.solve import Method, SolverParams, solve

__all__ = ["Method", "SolverParams", "solve", "pendulum"]

__version__ = "0.1.0"
