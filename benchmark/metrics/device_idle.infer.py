"""device_idle.infer: 1 - the union of kernel and copy intervals over the profiled slice's
wall time, in % (eval cells)."""


def read(record):
    p = record.profile
    if record.entry != "eval_loop" or p is None:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
