"""The highway-LSTM layer kernel (K4, csrc/highway_lstm.cu) against the eager
loop on a card:

    python3 scripts/torch_highway_lstm_card.py [--out DIR] [--ptxas]

At the sgdet cell's shapes (B 16, T 64, H 512, every row 64 long): one
layer of each stack alone (the kernel on a precomputed gi, the eager loop
`_run_layer`), then each stack whole (2 object layers on 4424 inputs, 4
edge layers on 4808, the input GEMMs included) and the 6 layers together;
then the same stacks at a predcls batch's real lengths (16 images of the
predcls.b16 traffic's pool, 64 slots). For each: the kernel's device time
(CUDA events around 20 launches in a row, over the count), a synced call
(the median of 10 calls, each synchronized, on the host clock), the eager
loop's synced call, the largest difference between the two outputs, and
the bound (2*H*5H f32 operations for each row's each real step, over 67
TFLOP/s; bytes over 3.35 TB/s), with the operations of the kernel's own
padded grid beside it (every row of the batch to the longest length). `--ptxas` first compiles the source
with `-Xptxas -v` and prints its registers, shared memory and spills.
Output: DIR/highway_lstm_card.json (default build/highway_lstm).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from neural_motifs_tpu_torch.ops import _cuda  # noqa: E402
from neural_motifs_tpu_torch.ops import highway_lstm as hl  # noqa: E402

B, T, H = 16, 64, 512
STACKS = {"obj": (4424, 2), "edge": (4808, 4)}
F32_PEAK, HBM = 67e12, 3.35e12


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def ptxas() -> None:
    src = os.path.join(ROOT, "neural_motifs_tpu_torch", "csrc", "highway_lstm.cu")
    out = os.path.join(ROOT, "build", "highway_lstm_ptxas.o")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [_cuda._find_nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed ({proc.returncode})")


def synced_ms(fn, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(lengths, d_ins) -> dict:
    """The bound: operations, the recurrent product of each row's real
    steps (sum(lengths) rows of 2*H*5H a layer); bytes, gi read, W_h read,
    the output written, a layer each. Beside it the kernel's own work,
    `grid_ops_ms`: its 16-row tile runs every row to the longest length."""
    ops = len(d_ins) * 2 * int(sum(lengths)) * H * 5 * H
    grid_ops = len(d_ins) * 2 * B * int(max(lengths)) * H * 5 * H
    nbytes = len(d_ins) * 4 * (B * T * 6 * H + H * 5 * H + 5 * H + B * T * H)
    return {"ops_ms": 1e3 * ops / F32_PEAK, "grid_ops_ms": 1e3 * grid_ops / F32_PEAK,
            "bytes_ms": 1e3 * nbytes / HBM}


def stack(rng, d_in: int, layers: int, dev) -> list:
    params = []
    for layer in range(layers):
        k = d_in if layer == 0 else H
        bias = rng.uniform(-0.1, 0.1, 5 * H)
        bias[H:2 * H] += 1.0
        params.append({n: torch.tensor(v, dtype=torch.float32, device=dev) for n, v in (
            ("w_i", rng.uniform(-1, 1, (k, 6 * H)) / np.sqrt(k)),
            ("w_h", rng.uniform(-1, 1, (H, 5 * H)) / np.sqrt(H)),
            ("bias", bias))})
    return params


def predcls_lengths() -> np.ndarray:
    from benchmark.traffic.scenes import draw_sizes
    with open(os.path.join(ROOT, "benchmark", "traffic", "predcls.b16.json")) as f:
        params = json.load(f)["scenes"]
    return draw_sizes(params)[0][:B]


def measure(name: str, params: list, x, lengths, layer_only: bool) -> dict:
    """One stack (or its first layer alone, on a precomputed gi)."""
    lens = torch.tensor(lengths, dtype=torch.int64, device=x.device)
    with torch.inference_mode():
        if layer_only:
            p = params[0]
            gi = x @ p["w_i"]
            mask = torch.arange(T, device=x.device)[None, :] < lens[:, None]

            def kernel():
                return hl.highway_lstm_cuda(gi, p["w_h"], p["bias"], lens)

            def plain():
                return hl._run_layer(x, mask, p["w_i"], p["w_h"], p["bias"], None, False)
            d_ins = [x.shape[-1]]
        else:
            def kernel():
                return hl.alternating_highway_lstm(params, x, lens)

            def plain():
                return hl._alternating(params, x, lens, None, kernel=False)
            d_ins = [x.shape[-1]] + [H] * (len(params) - 1)
        err = (kernel() - plain()).abs().max().item()
        row = {"name": name, "layers": len(d_ins), "max_len": int(max(lengths)),
               "device_ms": device_ms(kernel), "synced_ms": synced_ms(kernel),
               "plain_ms": synced_ms(plain), "max_abs_err": err,
               **bound_ms(lengths, d_ins)}
    print(f"{name}: {row['layers']} layer(s), longest {row['max_len']}: kernel device "
          f"{row['device_ms']:.4f} ms, synced call {row['synced_ms']:.4f} ms; eager loop "
          f"{row['plain_ms']:.3f} ms; bound {row['ops_ms']:.4f} ms (operations), "
          f"{row['bytes_ms']:.4f} ms (bytes), the kernel's grid {row['grid_ops_ms']:.4f} ms "
          f"(operations); max abs diff {err:.3g}", flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "highway_lstm"))
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.ptxas:
        ptxas()
    rng = np.random.default_rng(0)
    stacks = {k: stack(rng, d, n, dev) for k, (d, n) in STACKS.items()}
    xs = {k: torch.tensor(rng.standard_normal((B, T, d)), dtype=torch.float32, device=dev)
          for k, (d, _) in STACKS.items()}
    rows = []
    for lname, lengths in (("sgdet", np.full(B, T)), ("predcls", predcls_lengths())):
        print(f"{lname} lengths: {lengths.tolist()}", flush=True)
        for k in STACKS:
            rows.append(measure(f"{lname} {k} layer 0", stacks[k], xs[k], lengths, True))
        for k in STACKS:
            rows.append(measure(f"{lname} {k} stack", stacks[k], xs[k], lengths, False))
        six = {f: sum(r[f] for r in rows[-2:])
               for f in ("device_ms", "synced_ms", "plain_ms", "ops_ms", "grid_ops_ms", "bytes_ms")}
        rows.append({"name": f"{lname} 6 layers", **six})
        print(f"{lname} 6 layers: kernel device {six['device_ms']:.4f} ms, synced "
              f"{six['synced_ms']:.4f} ms; eager loop {six['plain_ms']:.3f} ms; bound "
              f"{six['ops_ms']:.4f} ms, the kernel's grid {six['grid_ops_ms']:.4f} ms",
              flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "highway_lstm_card.json")
    with open(path, "w") as f:
        json.dump({"card": card(), "rows": rows}, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
