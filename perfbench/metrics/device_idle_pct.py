"""The share of the traced window in which no operation ran on the device,
in percent."""


def read(rec):
    tr = rec["trace"]
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
