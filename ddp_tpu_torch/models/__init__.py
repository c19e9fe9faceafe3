from ddp_tpu_torch.models import base, pendulum

__all__ = ["base", "pendulum"]
