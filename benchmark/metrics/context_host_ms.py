"""context_host_ms: Host time inside LinearizedContext a batch (unsynced hooks: the time
the host spends queueing its loops)."""

import numpy as np


def read(record):
    c = record.spans.get("context")
    if record.entry != "eval_loop" or not c or not record.batches:
        return None
    return 1e3 * float(np.sum(c)) / record.batches
