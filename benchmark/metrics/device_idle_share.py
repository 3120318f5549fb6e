"""The device's idle share over profiled calls (one of each orientation):
1 - (the union of the intervals in which a device operation ran) / (the
traced window's wall), from ``torch.profiler``'s trace, in %."""


def read(rec):
    p = rec.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
