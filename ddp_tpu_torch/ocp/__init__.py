from ddp_tpu_torch.ocp import constraints, costs, dynamics, problem

__all__ = ["constraints", "costs", "dynamics", "problem"]
