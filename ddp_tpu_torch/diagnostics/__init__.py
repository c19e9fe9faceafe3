"""Diagnostics of the port (≙ ddp_tpu/diagnostics/)."""
