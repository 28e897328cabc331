"""95th percentile of the wall time of every solve in the window (host
clock), linear between the two nearest ranks."""


def percentile(values, q: float) -> float:
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def read(run):
    w = run.window
    if not w or not w.get("latencies_s"):
        return None
    return percentile(w["latencies_s"], 95.0) * 1e3
