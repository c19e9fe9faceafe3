"""Device-mesh scaling of the solve batch (≙ ddp_tpu/parallel)."""
