"""infer_p90_ms: The 90th percentile, over every batch the window completed, of the time
from the batch's forward call to the end of its consume (eval cells)."""

import numpy as np


def read(record):
    if record.entry != "eval_loop" or len(record.latencies_s) < 10:
        return None
    return 1e3 * float(np.percentile(record.latencies_s, 90))
