"""The benchmark of neural_motifs_tpu_torch on NVIDIA GPUs:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. See benchmark/README.md."""

import os
import sys

# one process a card, few host threads: the port's host work is one
# thread's, and idle pools spinning beside it make its time wander
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "2")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.lib.harness import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=process_start()))
