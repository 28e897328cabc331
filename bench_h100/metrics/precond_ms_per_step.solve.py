"""Device time under the preconditioner range per step executed, in ms."""


def read(run):
    steps = run.counters.get("steps")
    t = run.trace
    if not steps or not t or not t["device_ops"]:
        return None
    return t["device_s_by_range"].get("bench.precond", 0.0) / steps * 1e3
