"""The operator apply's share of its HBM bound, in %: (nnz + 2 n) * 8
bytes over the card's published rate, divided by the device time under
the operator range per apply (the wrapper's padded copy of x included)."""

from bench_h100 import roofline


def read(run):
    t = run.trace
    if not t or not t["device_ops"]:
        return None
    rate = roofline.hbm_bytes_per_s(run.torch.cuda.get_device_name(0))
    applies = t["range_counts"].get("bench.operator", 0)
    dev = t["device_s_by_range"].get("bench.operator", 0.0)
    if rate is None or not applies:
        return None
    bound = roofline.spmv_bytes(run.n_rows, run.n_cols, run.nnz) / rate
    return roofline.share_percent(bound, dev / applies)
