"""A cell of BENCHMARK.json at a tiny size on the CPU, for the CPU tests:
the harness's look for a chip skipped, the rest of a run driven (set-up,
window, judgement, result line) with the configuration's widths cut, the
images at 96 px (NM_TPU_IM_SCALE, set before the port is imported), two
images a batch and a pool of 4 (the 2 batches a window must finish to be judged).

    NM_TPU_IM_SCALE=96 python -m benchmark.tests.tiny --workload <cell> \
        [--fault <name>] [--control fp8] [--dtype bfloat16] [--seconds 15]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from types import SimpleNamespace

TINY_IM = 96
TINY_WIDTHS = {"obj_dim": 32, "pooling_dim": 32, "hidden_dim": 16, "embed_dim": 8}
TINY_GT = 12


def tiny_files(conf: dict, traffic: dict, dtype: str) -> tuple[dict, dict]:
    """The configuration and traffic cut to the tiny size."""
    conf = dict(conf, image_size=TINY_IM, compute_dtype=dtype)
    argv = list(conf["argv"])
    for k, v in TINY_WIDTHS.items():
        if k in conf:
            conf[k] = v
            flag = f"-{k}"
            if flag in argv:
                argv[argv.index(flag) + 1] = str(v)
            else:
                argv += [flag, str(v)]
    conf["argv"] = argv + ["-max_gt_boxes", str(TINY_GT), "-objs_per_img", str(TINY_GT)]
    conf["budgets"] = dict(conf["budgets"], max_gt_boxes=TINY_GT, objs_per_img=TINY_GT)
    traffic = copy.deepcopy(traffic)
    traffic["batch"] = 2
    traffic["scenes"]["pool_images"] = 4
    traffic["scenes"]["image_size"] = TINY_IM
    traffic["scenes"]["objects"]["max"] = TINY_GT
    return conf, traffic


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--control", default=None)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=2 ** 31 + 7)
    a = p.parse_args(argv)
    if os.environ.get("NM_TPU_IM_SCALE") != str(TINY_IM):
        raise SystemExit(f"set NM_TPU_IM_SCALE={TINY_IM}")
    import torch
    torch.set_num_threads(2)
    from benchmark.lib import harness
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, conf, traffic = harness.load_cell(spec, a.workload)
    conf, traffic = tiny_files(conf, traffic, a.dtype)
    args = SimpleNamespace(workload=a.workload, seed=a.seed, seconds=a.seconds, trace=0,
                           control=a.control, fault=a.fault)
    ctx = harness.Context(args, cell, conf, traffic, torch.device("cpu"), time.perf_counter())
    real_stdout, sys.stdout = sys.stdout, sys.stderr
    try:
        import importlib
        driver = importlib.import_module(f"benchmark.drivers.{traffic['entry']}")
        record = driver.run(ctx)
        result = harness.finish(spec, ctx, record)
    finally:
        sys.stdout = real_stdout
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
