"""relhead_device_ms: Device time a batch of the kernels launched inside the union-box and
union-tower modules (rel_model.pair_visual_rep), in the profiled slice."""


def read(record):
    p = record.profile
    if record.entry != "eval_loop" or p is None:
        return None
    n = p["range_counts"].get("bench.forward", 0)
    t = p["range_device_s"].get("bench.relhead")
    return 1e3 * t / n if n and t else None
