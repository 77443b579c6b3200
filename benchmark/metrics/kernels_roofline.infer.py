"""kernels_roofline.infer: The summed least time of the profiled slice's launches of K1-K3, over
the device time of those kernels, in % (eval cells)."""

from benchmark.arith import roofline as R


def read(record):
    if record.entry != "eval_loop" or record.profile is None:
        return None
    return R.kernel_share(record.kernel_bound_ms, record.profile["kernel_s"])
