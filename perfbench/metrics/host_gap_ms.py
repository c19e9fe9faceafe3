"""Host work of a call: each call span's wall time less the device time of
the work its launches made, averaged over the traced window's calls, in
milliseconds (the wrapper's argument checks, packing, allocations and the
launch, plus the synchronisation's return)."""


def read(rec):
    calls = rec["trace"].get("calls")
    if not calls:
        return None
    return 1e3 * sum(wall - dev for wall, dev in calls) / len(calls)
