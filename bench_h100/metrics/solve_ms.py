"""The window's wall time over the solves completed in it (host clock)."""


def read(run):
    w = run.window
    return w["wall_s"] / w["count"] * 1e3 if w and w["count"] else None
