"""The 95th percentile of every call's time in the window, from the call's
entry to its synchronised result (host clock), in milliseconds."""

import statistics


def read(rec):
    ms = [1e3 * s for s in rec["call_s"]]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
