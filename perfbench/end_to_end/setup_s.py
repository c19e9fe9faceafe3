"""Seconds from the start of the process to the end of the warm-up calls:
imports, the device context, loading (on a checkout's first run, building)
the kernel's library, the problem and the inputs from the seed, and the warm
calls at the cell's own size."""


def read(rec):
    return rec["setup_s"]
