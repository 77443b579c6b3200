"""mfu.infer: The operations the window's inputs need (benchmark/arith/flops.py) over
the window's seconds, as a share of the bf16 dense peak, in %."""

from benchmark.arith import roofline as R


def read(record):
    if record.entry != "eval_loop" or not record.flops or not record.window_s:
        return None
    return 100.0 * record.flops / record.window_s / R.PEAK_BF16_FLOPS
