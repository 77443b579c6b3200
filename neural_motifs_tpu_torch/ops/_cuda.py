"""Build and load the port's CUDA kernels.

On first use the sources under `neural_motifs_tpu_torch/csrc/` are compiled
with nvcc for Hopper (`sm_90a`), one nvcc process a source, all started
together, and linked into one shared library with a plain C interface under
`build/torch_kernels/` at the repository root, keyed by a hash of the
sources and flags, and loaded with ctypes. A C entry point
returns the launch's `cudaGetLastError()`; `check` raises on a non-zero
code. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# No --use_fast_math: the NMS kernels must reproduce the IEEE IoU division
# of the plain versions bit for bit, or keep decisions flip.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes (pointers and the stream as void*)
_SIGNATURES = {
    # fmap, rois, valid, out, B, H, W, C, R, P, spatial_scale, is_bf16, stream
    "nm_roi_align_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # H, W, P -> 1 where the backward takes its shared-memory kernel
    "nm_roi_align_bwd_smem_fits": (_I, _I, _I),
    # g, rois, valid, acc (f32, the scatter path's), out, B, H, W, C, R, P,
    # spatial_scale, g_is_bf16, out_is_bf16, smem, stream
    "nm_roi_align_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    # boxes, valid, keep, lanes, K, thresh, stream
    "nm_perclass_nms": (_P, _P, _P, _I, _I, _F, _P),
    # boxes, valid, mask, keep, lanes, N, thresh, stream
    "nm_greedy_nms": (_P, _P, _P, _P, _I, _I, _F, _P),
    # gi, w_h, bias, lengths, dropout mask (or 0), out, B, T, H, reverse,
    # stream
    "nm_highway_lstm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "the port's CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into one shared library unless a build of the same
    sources and flags exists: each source to an object by its own nvcc, all
    at once, then one link. Returns its path; raises with the compiler's
    output on failure."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")) + sorted(CSRC.glob("*.h")):
        digest.update(f.name.encode() + f.read_bytes())
    out = BUILD_DIR / f"libnm_torch_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            _check_nvcc(cmd, proc.communicate()[0], proc.returncode)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check_nvcc(cmd, proc.stdout + proc.stderr, proc.returncode)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)   # atomic: a concurrent process never loads a partial file
    return out


def _check_nvcc(cmd: list, output: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{output}")


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return so


def check(code: int, what: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Wrapper-side checks shared by the kernels: every tensor on one CUDA
    device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
