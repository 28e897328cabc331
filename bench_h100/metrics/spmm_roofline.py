"""One rt.spmv(A, X)'s share of its HBM bound, in %: (nnz + 2 n k) * 8
bytes over the card's published rate, divided by the device time of the
product (its padded copies of X and Y included)."""

from bench_h100 import roofline


def read(run):
    t = run.trace
    if not t or not t["device_ops"]:
        return None
    rate = roofline.hbm_bytes_per_s(run.torch.cuda.get_device_name(0))
    applies = t["range_counts"].get("bench.apply", 0)
    dev = t["device_s_by_range"].get("bench.apply", 0.0)
    if rate is None or not applies:
        return None
    bound = roofline.spmv_bytes(run.n_rows, run.n_cols, run.nnz,
                                columns=int(run.traffic["columns"])) / rate
    return roofline.share_percent(bound, dev / applies)
