"""device_idle.train: 1 - the union of kernel and copy intervals over the profiled slice's
wall time, in % (training)."""


def read(record):
    p = record.profile
    if record.entry != "train_loop" or p is None:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
