"""Process start to the first timed solve or product (host clock)."""


def read(run):
    return run.setup_s
