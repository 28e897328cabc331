"""The window's wall time over the products issued in it (host clock; the
window closes with a device synchronize)."""


def read(run):
    w = run.window
    return w["wall_s"] / w["count"] * 1e6 if w and w["count"] else None
