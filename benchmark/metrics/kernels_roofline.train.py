"""kernels_roofline.train: The summed least time of the profiled slice's launches of K1, K1's
backward and K3, over the device time of those kernels, in % (training)."""

from benchmark.arith import roofline as R


def read(record):
    if record.entry != "train_loop" or record.profile is None:
        return None
    return R.kernel_share(record.kernel_bound_ms, record.profile["kernel_s"])
