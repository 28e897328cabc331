"""1 - device busy / wall over the traced stretch of solves."""


def read(run):
    t = run.trace
    if not t or not t["device_ops"] or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
