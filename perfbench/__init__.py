"""The benchmark of ddp_tpu_torch: run ``python perfbench/run.py --help``."""
