"""step_host_ms: Mean host time of a train step call over the window (train_epoch's
`step_s`: the forward, backward and optimizer queued, and the one read
of the step's finite flag)."""

import numpy as np


def read(record):
    if record.entry != "train_loop" or not record.step_s:
        return None
    return 1e3 * float(np.mean(record.step_s))
