"""Device operations (kernels, copies, fills) launched inside the solves,
per step executed."""

RANGES = ("bench.solve", "bench.operator", "bench.precond")


def read(run):
    steps = run.counters.get("steps")
    t = run.trace
    if not steps or not t or not t["device_ops"]:
        return None
    n = t["device_ops_by_range"]
    return sum(n.get(r, 0) for r in RANGES) / steps
