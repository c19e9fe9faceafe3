"""The least time of a call's work on the card (the route's frozen counts:
the larger of its operations at the float32 peak and its bytes at the
memory rate) over the device time of a call as ``kernel_device_ms`` reads
it, in percent."""


def read(rec):
    counts, calls = rec.get("counts"), rec["trace"].get("calls")
    if not counts or not calls:
        return None
    device_s = sum(d for _, d in calls) / len(calls)
    if device_s <= 0:
        return None
    return 100.0 * 1e-3 * counts["bound_ms"] / device_s
