"""Host time of one rt.spmv(A, X) call, in us: the host clock around
bursts of products issued right after a synchronize, summed until the
traffic mix's host_seconds, over the products issued."""


def read(run):
    return run.host_call_us
