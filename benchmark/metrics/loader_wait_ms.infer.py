"""loader_wait_ms.infer: Mean host time a batch waits on the loader (`next()` on the loader
handed to the eval loop)."""

import numpy as np


def read(record):
    w = record.spans.get("loader_wait")
    return 1e3 * float(np.mean(w)) if record.entry == "eval_loop" and w else None
