"""Device time of the solves outside the operator and preconditioner
ranges (the solver's vector work), per step executed, in ms."""


def read(run):
    steps = run.counters.get("steps")
    t = run.trace
    if not steps or not t or not t["device_ops"]:
        return None
    return t["device_s_by_range"].get("bench.solve", 0.0) / steps * 1e3
