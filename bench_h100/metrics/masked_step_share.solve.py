"""(steps executed - iterations) / steps executed over the traced solves:
the masked steps of the chunked loop. Steps from the port's launch
counters, iterations from SolverInfo."""


def read(run):
    steps = run.counters.get("steps")
    if not steps:
        return None
    return (steps - run.counters["iterations"]) / steps
