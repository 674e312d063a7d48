"""scan_GBps: corpus bytes of every count completed in the window over
the window's host-clock seconds, in GB/s (on several cards the whole
corpus's bytes)."""


def read(run):
    if not run["counts"] or run["window_s"] <= 0:
        return None
    return run["bytes_per_count"] * run["counts"] / run["window_s"] / 1e9
