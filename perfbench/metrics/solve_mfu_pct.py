"""The whole solve's share of the card's float32 peak: the frozen operation
count of the recipe for every lane solved in the traced window, over the
window's seconds times 67 TFLOP/s, in percent.  It reads the same work
whatever kernels implement it."""


def read(rec):
    counts, tr = rec.get("counts"), rec["trace"]
    if not counts or not tr.get("window_s") or not tr.get("calls"):
        return None
    ops = counts["ops"] * len(tr["calls"])  # counts are of one call's lanes
    return 100.0 * ops / (tr["window_s"] * counts["peak_flops"])
