"""Device time of a call: the union of the device work launched inside each
call span (by the launches' correlation, not by kernel name), averaged over
the traced window's calls, in milliseconds."""


def read(rec):
    calls = rec["trace"].get("calls")
    if not calls:
        return None
    dev = sum(d for _, d in calls) / len(calls)
    return 1e3 * dev if dev > 0 else None
