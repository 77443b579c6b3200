"""loader_wait_ms.train: Mean host time a step waits on the loader (`next()` on the loader
handed to train_epoch)."""

import numpy as np


def read(record):
    w = record.spans.get("loader_wait")
    return 1e3 * float(np.mean(w)) if record.entry == "train_loop" and w else None
