// Exact greedy NMS kernels for Hopper: per-class (K2) and single-lane (K3).
//
// K2 replaces the Pallas TPU kernel neural_motifs_tpu/ops/pallas_nms.py
// pallas_perclass_nms; K3 replaces pallas_greedy_nms in the same file.
// Both reproduce the IoU expression of the JAX kernels bit for bit,
//   iou = inter / max(area_a + area_b - inter, 1e-8)   (+1 inclusive widths)
// with every operation an explicit IEEE round-to-nearest intrinsic, so nvcc
// cannot contract a multiply and an add into one FMA and flip a decision
// that sits on the threshold.
//
// What bounds K3 on the card: not bytes (0.5 MB of boxes, scores and flags
// in, the keep mask out) nor the IoUs (at most N^2/2, 72 M at [4, 6000],
// ~17 us of f32 work over 132 SMs), but the greedy order: box i's fate
// depends on every kept box before it, so each lane is one sequential
// walk on one SM. A walk that pays one dependent device-memory load per
// kept box (~0.5 us each, thousands of kept boxes a lane) runs for
// milliseconds. The design below pays the dependent latency once per 64
// boxes, from shared memory, with the next tile already on its way. What
// is left is the tile stream into one SM: at [4, 6000] on an H100 a walk
// with the same copies and barriers, one fixpoint round and no apply takes
// as long as the whole scan (~0.9 us a 64-box chunk, ~53 GB/s; the probe
// builds are recorded in PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.f));
}

__device__ __forceinline__ float inter_plus1(float ax1, float ay1, float ax2,
                                             float ay2, float bx1, float by1,
                                             float bx2, float by2) {
  const float iw = __fadd_rn(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 1.f);
  const float ih = __fadd_rn(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 1.f);
  return __fmul_rn(fmaxf(iw, 0.f), fmaxf(ih, 0.f));
}

__device__ __forceinline__ float iou_from_inter(float inter, float area_a,
                                                float area_b) {
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-8f));
}

__device__ __forceinline__ float iou_plus1(float ax1, float ay1, float ax2,
                                           float ay2, float area_a, float bx1,
                                           float by1, float bx2, float by2,
                                           float area_b) {
  return iou_from_inter(inter_plus1(ax1, ay1, ax2, ay2, bx1, by1, bx2, by2),
                        area_a, area_b);
}

// ---------------------------------------------------------------------------
// K2 — per-class NMS (pallas_perclass_nms / _perclass_kernel): an exact
// rank-sequential greedy pass over the K candidates of each (image, class)
// lane, sorted by descending score.
//
// The TPU kernel vectorises one rank step over all C classes of an image
// on the VPU and walks the K ranks in its grid body. Here one block owns
// one lane (B*C = 604 blocks at the main path fill the 132 SMs), with one
// thread per candidate: the lane's boxes and areas sit in shared memory,
// and the block walks rank i = 0..K-1; if box i is still alive, every
// thread j > i drops its own box when IoU(i, j) > t. A box's alive flag is
// final before its own step (only lower ranks can kill it), so one pass is
// exact greedy. Bound: the K dependent steps, each a few hundred cycles
// of shared-memory work and one __syncthreads; no device-memory traffic
// beyond loading the boxes once. Dead ranks are skipped without a barrier
// (every thread reads the same settled flag).
// ---------------------------------------------------------------------------

__global__ void perclass_nms_kernel(const float* __restrict__ boxes,
                                    const uint8_t* __restrict__ valid,
                                    uint8_t* __restrict__ keep, int K,
                                    float thresh) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* ar = y2 + K;
  int* alive = reinterpret_cast<int*>(ar + K);

  const int64_t lane = blockIdx.x;
  const float* bx = boxes + lane * K * 4;
  const uint8_t* vl = valid + lane * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    x1[j] = bx[j * 4 + 0];
    y1[j] = bx[j * 4 + 1];
    x2[j] = bx[j * 4 + 2];
    y2[j] = bx[j * 4 + 3];
    ar[j] = box_area(x1[j], y1[j], x2[j], y2[j]);
    alive[j] = vl[j] != 0;
  }
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    if (!alive[i]) continue;  // uniform: flag i is settled and shared
    const float ix1 = x1[i], iy1 = y1[i], ix2 = x2[i], iy2 = y2[i], ia = ar[i];
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      if (j > i && iou_plus1(ix1, iy1, ix2, iy2, ia, x1[j], y1[j], x2[j],
                             y2[j], ar[j]) > thresh) {
        alive[j] = 0;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    keep[lane * K + j] = (uint8_t)alive[j];
  }
}

// ---------------------------------------------------------------------------
// K3 — greedy NMS over L lanes of N score-sorted boxes (pallas_greedy_nms /
// _nms_kernel, which resolves a tile fixpoint and one [T, N] suppression
// sweep per 128-box tile inside VMEM). On the GPU the work splits the way
// the reference's bitmask kernel splits it (lib/fpn/nms/src/cuda/
// nms_kernel.cu), with the greedy scan kept on the device:
//
//   nms_mask_kernel: mask[l, i, v] is the 64-bit word whose bit k says
//     IoU(i, 64v + k) > t, for 64v + k > i (rows of W = ceil(N/64) words,
//     padded to even for 16-byte rows). Only the W(W+1)/2 tiles of 64x64
//     boxes on or right of the diagonal are launched (a 1-D block index
//     mapped to (row block, col block)); 128 threads, two a row, each
//     testing 32 columns. A pair that does not intersect skips the division
//     (0 / x = 0, so its decision is 0 > t).
//   nms_scan_kernel: one block a lane walks the lane in 64-box chunks. The
//     chunk's 64 mask rows arrive in a shared-memory double buffer by TMA
//     bulk copies, one tile ahead: whole rows in one copy where W <= 128,
//     else pieces of 128 words, one copy a row. Each of the 4 warps (one a
//     scheduler) resolves the chunk's 64 decisions from the chunk's own
//     word of each row (the fixpoint of alive = base & ~OR(alive rows), two
//     rows a lane, warp OR-reductions), so no barrier hands the answer on;
//     then each thread ORs the kept rows' words into the removed word of
//     one later column. The dependent latency is paid once a chunk, from
//     shared memory.
//
// The boxes arrive sorted by descending score (the wrapper sorts and
// scatters the keep mask back to the original order).
// ---------------------------------------------------------------------------

constexpr int kBits = 64;
constexpr int kMaskThreads = 128;
constexpr int kScanThreads = 128;  // also the widest tile piece, in words

// The bits lo <= c < hi of a 32-bit word (lo, hi any ints).
__device__ __forceinline__ unsigned int bit_range(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 32);
  if (lo >= hi) return 0u;
  const unsigned int upto = hi == 32 ? 0xffffffffu : (1u << hi) - 1u;
  return upto & (0xffffffffu << lo);
}

__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float* __restrict__ boxes, int N, int col_blocks,
                    float thresh, unsigned long long* __restrict__ mask) {
  // tile k of the upper triangle in column order: col block cb holds the
  // row blocks 0..cb, so it starts at k = cb (cb + 1) / 2
  const int k = blockIdx.x;
  int cb = (int)((sqrtf(8.f * (float)k + 1.f) - 1.f) * 0.5f);
  while ((cb + 1) * (cb + 2) / 2 <= k) ++cb;
  while (cb * (cb + 1) / 2 > k) --cb;
  const int rb = k - cb * (cb + 1) / 2;
  const int64_t lane = blockIdx.y;

  __shared__ float4 cbox[kBits];
  __shared__ float car[kBits];
  const float* lb = boxes + lane * N * 4;
  const int rows = min(N - rb * kBits, kBits);
  const int cols = min(N - cb * kBits, kBits);
  const int t = threadIdx.x;
  const int r = t >> 1;         // the row of this thread pair
  const int k0 = (t & 1) * 32;  // its half of the 64 columns
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);  // its row's box, loaded early
  if (r < rows) {
    const float* p = lb + (int64_t)(rb * kBits + r) * 4;
    a = make_float4(p[0], p[1], p[2], p[3]);
  }
  if (t < cols) {
    const float* p = lb + (int64_t)(cb * kBits + t) * 4;
    cbox[t] = make_float4(p[0], p[1], p[2], p[3]);
    car[t] = box_area(p[0], p[1], p[2], p[3]);
  }
  __syncthreads();
  const bool zero_hit = 0.f > thresh;  // a pair that does not intersect
  unsigned int bits = 0u;
  if (r < rows) {
    const float ax1 = a.x, ay1 = a.y, ax2 = a.z, ay2 = a.w;
    const float aa = box_area(ax1, ay1, ax2, ay2);
    // all 32 columns, then keep those past the diagonal and inside N
    // (the others read stale shared memory, harmlessly)
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float4 q = cbox[k0 + c];
      const float inter = inter_plus1(ax1, ay1, ax2, ay2, q.x, q.y, q.z, q.w);
      const bool hit = inter == 0.f
                           ? zero_hit
                           : iou_from_inter(inter, aa, car[k0 + c]) > thresh;
      bits |= (unsigned int)hit << c;
    }
    bits &= bit_range((cb == rb ? r + 1 : 0) - k0, cols - k0);
  }
  const unsigned int hi = __shfl_down_sync(0xffffffffu, bits, 1);
  if (r < rows && k0 == 0) {
    const int Wp = col_blocks + (col_blocks & 1);  // 16-byte rows
    mask[(lane * N + rb * kBits + r) * Wp + cb] =
        ((unsigned long long)hi << 32) | bits;
  }
}

// mbarrier and 1-D bulk-copy (TMA) helpers, shared::cta addresses.
__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const unsigned long long* __restrict__ mask,
                    const uint8_t* __restrict__ valid, int N, int col_blocks,
                    uint8_t* __restrict__ keep) {
  const int W = col_blocks;
  const int Wp = W + (W & 1);           // the mask's row stride: 16-byte rows
  const int pw = min(W, kScanThreads);  // the words one tile piece applies
  // a tile's row stride: whole mask rows where they fit (one bulk copy a
  // tile), else the piece with its alignment word, even
  const bool whole = W <= kScanThreads;
  const int ps = whole ? Wp : (pw + 3) & ~1;
  extern __shared__ __align__(16) unsigned long long sm[];
  unsigned long long* tiles = sm;                         // [2][64][ps]
  unsigned long long* removed = tiles + 2 * kBits * ps;  // [W]
  unsigned long long* vbits = removed + W;                // [W] valid bits
  __shared__ __align__(8) unsigned long long bars[2];   // a tile has landed

  const int64_t lane = blockIdx.x;
  const int t = threadIdx.x;
  const int l = t & 31;  // lane of the warp
  const unsigned long long* m = mask + lane * N * (int64_t)Wp;
  uint8_t* kp = keep + lane * N;

  if (t == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tile (w, c0) into buffer buf: rows 64w.. of the mask. Whole rows are
  // one contiguous bulk copy; a piece is one bulk copy a row of the words
  // from c0 rounded down to even to the piece's end rounded up to even
  // (16-byte aligned, a multiple of 16 bytes). Word v of a row sits at
  // column v - first(c0).
  auto first = [&](int c0) { return whole ? 0 : c0 & ~1; };
  auto issue = [&](int w, int c0, int buf) {
    const int rows = min(N - w * kBits, kBits);
    const unsigned long long* src = m + (int64_t)w * kBits * Wp;
    unsigned long long* dst = tiles + buf * kBits * ps;
    if (whole) {
      if (t == 0) {
        const unsigned int bytes = (unsigned int)(rows * Wp) * 8u;
        mbar_expect_tx(&bars[buf], bytes);
        bulk_copy(dst, src, bytes, &bars[buf]);
      }
      return;
    }
    const int c0a = first(c0);
    const unsigned int bytes =
        (unsigned int)(((min(W, c0 + pw) + 1) & ~1) - c0a) * 8u;
    if (t == 0) mbar_expect_tx(&bars[buf], bytes * rows);
    if (t < rows) {
      bulk_copy(dst + t * ps, src + (int64_t)t * Wp + c0a, bytes, &bars[buf]);
    }
  };
  issue(0, 0, 0);

  for (int w = t; w < W; w += kScanThreads) removed[w] = 0ULL;
  unsigned int* vb32 = reinterpret_cast<unsigned int*>(vbits);
  for (int base = 0; base < W * kBits; base += kScanThreads) {
    const int j = base + t;
    const unsigned int b = __ballot_sync(0xffffffffu, j < N && valid[lane * N + j]);
    if (l == 0 && j < W * kBits) vb32[j >> 5] = b;
  }

  unsigned int phase = 0u;  // bit b: the parity of buffer b's next landing
  int buf = 0;
  unsigned int kept_lo = 0u, kept_hi = 0u;  // the chunk's kept boxes
  for (int w = 0; w < W; ++w) {
    for (int c0 = w; c0 < W; c0 += pw) {
      mbar_wait(&bars[buf], (phase >> buf) & 1u);
      phase ^= 1u << buf;
      __syncthreads();  // the last removed words are in; buf ^ 1 is free
      const int nw = c0 + pw < W ? w : w + 1;
      if (nw < W) issue(nw, nw == w ? c0 + pw : nw, buf ^ 1);
      // word c0 of the piece at column 0
      const unsigned long long* tile = tiles + buf * kBits * ps + c0 - first(c0);
      if (c0 == w) {
        // resolve the chunk, in every warp (each on its own scheduler, so
        // no barrier has to hand the answer on): lane l holds rows l and
        // l + 32 of word w. alive = base & ~(OR of the alive rows) until it
        // stops changing; the rows only set bits above their own, so the
        // fixpoint is the greedy answer (one more bit is final each round,
        // and most chunks settle in a few; the bound only guards against a
        // corrupt mask). Rows past N are never alive.
        const unsigned long long base = vbits[w] & ~removed[w];
        const unsigned long long lo_row = tile[l * ps];
        const unsigned long long hi_row = tile[(l + 32) * ps];
        unsigned long long alive = base;
        for (int round = 0; round <= kBits; ++round) {
          const unsigned long long mine =
              (((alive >> l) & 1ULL) ? lo_row : 0ULL) |
              (((alive >> (l + 32)) & 1ULL) ? hi_row : 0ULL);
          const unsigned long long sup =
              ((unsigned long long)__reduce_or_sync(0xffffffffu,
                                                    (unsigned int)(mine >> 32))
               << 32) |
              __reduce_or_sync(0xffffffffu, (unsigned int)mine);
          const unsigned long long next = base & ~sup;
          if (next == alive) break;
          alive = next;
        }
        kept_lo = (unsigned int)alive;
        kept_hi = (unsigned int)(alive >> 32);
        if (t < 32) {
          const int i = w * kBits + l;
          if (i < N) kp[i] = (uint8_t)((kept_lo >> l) & 1u);
          if (i + 32 < N) kp[i + 32] = (uint8_t)((kept_hi >> l) & 1u);
        }
      }
      const int v = c0 + t;
      if (t < min(pw, W - c0) && v > w) {
        // the kept rows' words of column v ORed in: every row's word
        // loaded (independent loads), masked by its kept bit spread to 32
        // bits by an arithmetic shift
        unsigned int acc_lo = 0u, acc_hi = 0u;
#pragma unroll
        for (int k = 0; k < kBits; ++k) {
          const unsigned long long x = tile[k * ps + t];
          const unsigned int half = k < 32 ? kept_lo : kept_hi;
          const unsigned int on = (unsigned int)((int)(half << (31 - (k & 31))) >> 31);
          acc_lo |= (unsigned int)x & on;
          acc_hi |= (unsigned int)(x >> 32) & on;
        }
        removed[v] |= ((unsigned long long)acc_hi << 32) | acc_lo;
      }
      buf ^= 1;
    }
  }
}

// Raises nms_scan_kernel's opt-in shared-memory limit on the current device
// to `smem`, once per device and size (not at every call of a launch-bound
// path).
constexpr int kMaxDevices = 64;

cudaError_t raise_scan_smem_limit(size_t smem) {
  static std::mutex mu;
  static size_t limits[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= limits[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(nms_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) limits[dev] = smem;
  return err;
}

}  // namespace

// boxes [lanes, K, 4] f32 sorted per lane, valid [lanes, K] uint8
// -> keep [lanes, K] uint8.
extern "C" int nm_perclass_nms(const void* boxes, const void* valid,
                               void* keep, int lanes, int K, float thresh,
                               void* stream) {
  if (lanes == 0 || K == 0) return 0;
  const int threads = K >= 1024 ? 1024 : ((K + 31) / 32) * 32;
  const size_t smem = (size_t)K * (5 * sizeof(float) + sizeof(int));
  perclass_nms_kernel<<<lanes, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, thresh);
  return (int)cudaGetLastError();
}

// boxes [lanes, N, 4] f32 score-sorted, valid [lanes, N] uint8 (sorted the
// same way), mask scratch [lanes, N, W] u64 with W = ceil(N/64) rounded up
// to even -> keep [lanes, N] uint8 in sorted order.
extern "C" int nm_greedy_nms(const void* boxes, const void* valid, void* mask,
                             void* keep, int lanes, int N, float thresh,
                             void* stream) {
  if (lanes == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (N + kBits - 1) / kBits;
  const dim3 grid(col_blocks * (col_blocks + 1) / 2, lanes);
  nms_mask_kernel<<<grid, kMaskThreads, 0, s>>>(
      static_cast<const float*>(boxes), N, col_blocks, thresh,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ps = col_blocks <= kScanThreads ? col_blocks + (col_blocks & 1)
                                            : kScanThreads + 2;
  const size_t smem = (size_t)(2 * kBits * ps + 2 * col_blocks) *
                      sizeof(unsigned long long);
  err = raise_scan_smem_limit(smem);
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<lanes, kScanThreads, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), N, col_blocks,
      static_cast<uint8_t*>(keep));
  return (int)cudaGetLastError();
}
