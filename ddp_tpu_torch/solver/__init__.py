from ddp_tpu_torch.solver import al, riccati, rollout, solve

__all__ = ["al", "riccati", "rollout", "solve"]
