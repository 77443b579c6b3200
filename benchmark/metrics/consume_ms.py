"""consume_ms: Mean host time of a batch's consume: the evaluator's entries and its
Recall@K scoring."""

import numpy as np


def read(record):
    c = record.spans.get("consume")
    return 1e3 * float(np.mean(c)) if record.entry == "eval_loop" and c else None
