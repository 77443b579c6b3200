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

#include <cmath>
#include <mutex>

namespace {

constexpr int kBits = 64;  // ranks a suppression word covers

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

// Whether box p (area pa) suppresses box q of area qa: IoU > t, the division
// skipped where they do not meet (0 / x = 0).
__device__ __forceinline__ bool suppresses(float4 p, float pa, float4 q, float qa,
                                           float thresh, bool zero_hit) {
  const float inter = inter_plus1(p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w);
  return inter == 0.f ? zero_hit : iou_from_inter(inter, pa, qa) > thresh;
}

// ---------------------------------------------------------------------------
// K2 — per-class NMS, replacing pallas_perclass_nms / _perclass_kernel
// (neural_motifs_tpu/ops/pallas_nms.py): exact greedy NMS over the K
// candidates of each (image, class) lane, sorted by descending score.
//
// What bounds it on this card: neither bytes (18 bytes a candidate, 2.8 MB
// at [4, 151, 256]) nor the IoU tests' arithmetic (~20 M tests at most
// there, ~5 us of f32 work over 132 SMs), but the greedy order inside a
// lane (rank i's fate waits on every kept rank before it) and how fast one
// SM, holding ~5 lanes, issues the tests. A walk that meets at a barrier
// once per kept rank pays up to K dependent rounds a lane. The TPU kernel
// vectorises one rank step over the C classes of an image; here a lane is
// a block of four warps, and its walk goes by 64-rank chunks, as K3's scan
// does, with two barriers a chunk:
//   1. the chunk's upper-triangle suppression words, tested only between
//      its ranks still alive (valid and not removed), into shared memory;
//   2. every warp resolves the chunk by the fixpoint
//      alive = base & ~OR(rows of alive ranks);
//   3. the kept rows against the later ranks still alive, as items of a
//      kept row and a 32-rank word, ORed into `removed` by shared atomics.
// A test is the IoU expression in IEEE intrinsics up to the union, then
// the sign of two FMAs (k2_hit), the division only where they cannot
// decide. What sets the pace is how fast an SM issues those tests for the
// 4-5 lanes (16-20 warps) it holds, not the barriers (PERF.md). The
// boxes, their areas and the flags stay in shared memory (K = 2048 takes
// 43 KB, under the 48 KB default), so nothing but the boxes and flags in
// and the keep mask out touches device memory, and a chunk whose ranks are
// all gone costs no barrier.
// ---------------------------------------------------------------------------

constexpr int kLaneThreads = 128;  // a lane's block: four warps
constexpr int kLaneWarps = kLaneThreads / 32;  // each takes a slice of a tile
constexpr int kLanesPerSM = 5;  // 604 lanes over 132 SMs in one wave

// K2's test of IoU(p, q) > t without the division where the sign of an
// FMA settles it. With uni = max(union, 1e-8) > 0 and s the float after t,
// the f32 quotient inter / uni exceeds t if inter > s * uni, and cannot if
// inter <= t * uni; fma(-x, uni, inter) is inter - x * uni rounded once, so
// its sign is exact (for t in [2^-60, 2^60) no nonzero difference
// underflows). A quotient in (t, s], whose rounding decides, or a NaN sets
// `open`, and the caller then decides its tests by the IEEE division
// (`suppresses`); so does every test for a t outside that range, for which
// the host passes t1 = -inf and s = NaN.
__device__ __forceinline__ bool k2_hit(float4 p, float pa, float4 q, float qa, float t1,
                                       float s, bool& open) {
  const float inter = inter_plus1(p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(pa, qa), inter), 1e-8f);
  const bool hit = __fmaf_rn(-s, uni, inter) > 0.f;
  open |= !hit && !(__fmaf_rn(-t1, uni, inter) <= 0.f);
  return hit;
}

__device__ __forceinline__ unsigned long long chunk_word(const unsigned int* w32,
                                                         int w) {
  return ((unsigned long long)w32[2 * w + 1] << 32) | w32[2 * w];
}

__global__ void __launch_bounds__(kLaneThreads, kLanesPerSM)
    perclass_nms_kernel(const float* __restrict__ boxes,
                        const uint8_t* __restrict__ valid,
                        uint8_t* __restrict__ keep, int K, float thresh, float t1,
                        float t_next) {
  const int W = (K + kBits - 1) / kBits;
  extern __shared__ __align__(16) unsigned char k2_smem[];
  // the boxes and areas padded to whole chunks, so that an item's word of
  // column boxes lies inside them (a pad rank is never valid)
  float4* box = reinterpret_cast<float4*>(k2_smem);                // [64W]
  float* ar = reinterpret_cast<float*>(box + W * kBits);           // [64W]
  // a slice's part of each tile row, by rank: bit c is column c
  unsigned long long* tpart = reinterpret_cast<unsigned long long*>(ar + W * kBits);
  unsigned int* vbits = reinterpret_cast<unsigned int*>(tpart + kLaneWarps * kBits);  // [2W]
  unsigned int* removed = vbits + 2 * W;                                          // [2W]
  unsigned char* ranks = reinterpret_cast<unsigned char*>(removed + 2 * W);  // [warps][64]

  const int64_t lane = blockIdx.x;
  const int t = threadIdx.x;
  const int l = t & 31;
  const int warp = t >> 5;
  const float* bx = boxes + lane * K * 4;
  const uint8_t* vl = valid + lane * K;
  uint8_t* kp = keep + lane * K;

  for (int j = t; j < W * kBits; j += kLaneThreads) {
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < K) b = make_float4(bx[j * 4 + 0], bx[j * 4 + 1], bx[j * 4 + 2], bx[j * 4 + 3]);
    box[j] = b;
    ar[j] = box_area(b.x, b.y, b.z, b.w);
  }
  // whole warps take each step (64W is a multiple of 32): full ballots
  for (int j = t; j < W * kBits; j += kLaneThreads) {
    const unsigned int v = __ballot_sync(0xffffffffu, j < K && vl[j]);
    if (l == 0) {
      vbits[j >> 5] = v;
      removed[j >> 5] = 0u;
    }
  }
  __syncthreads();
  int v_end = 2 * W;  // one past the last word that holds a valid rank
  while (v_end > 0 && vbits[v_end - 1] == 0u) --v_end;

  const bool zero_hit = 0.f > thresh;
  for (int w = 0; w < W; ++w) {
    const int c0 = w * kBits;
    const int n = min(K - c0, kBits);
    // the chunk's ranks alive at its start; the same in every thread
    const unsigned long long base = chunk_word(vbits, w) & ~chunk_word(removed, w);
    if (base == 0ULL) {
      for (int r = t; r < n; r += kLaneThreads) kp[c0 + r] = 0;
      continue;
    }
    const float4* cb = box + c0;
    const float* ca = ar + c0;

    // 1. the tile, between the chunk's alive ranks only. They are indexed
    // a = 0..nb-1 (each warp writes its own list); lane x tests row x
    // against the columns above it, then row nb-1-x against the columns
    // above that, nb - 1 tests in all, and warp w takes the w-th slice of
    // them. The tests are independent (the compiler can overlap them); an
    // open one sends the thread's tests to the division.
    unsigned char* list = ranks + warp * kBits;
    if ((base >> l) & 1ULL) list[__popcll(base & ((1ULL << l) - 1ULL))] = (unsigned char)l;
    if ((base >> (l + 32)) & 1ULL)
      list[__popcll(base & ((1ULL << (l + 32)) - 1ULL))] = (unsigned char)(l + 32);
    __syncwarp();
    const int nb = __popcll(base);
    if (l < (nb + 1) / 2) {
      const int x = l, y = nb - 1 - l;  // y == x: the middle row, twice
      const int rx = list[x], ry = list[y];
      const float4 px = cb[rx], py = cb[ry];
      const float ax = ca[rx], ay = ca[ry];
      const int k0 = warp * (nb - 1) / kLaneWarps, k1 = (warp + 1) * (nb - 1) / kLaneWarps;
      unsigned long long bits_x = 0ULL, bits_y = 0ULL;  // bit c: column c of the row
      bool open = false;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const bool first = k < y;  // row x, column x + 1 + k; else row y, column k + 1
        const int rc = list[first ? x + 1 + k : k + 1];
        const bool hit = k2_hit(first ? px : py, first ? ax : ay, cb[rc], ca[rc], t1, t_next, open);
        bits_x |= (unsigned long long)(hit && first) << rc;
        bits_y |= (unsigned long long)(hit && !first) << rc;
      }
      if (open) {  // rare: these tests again, by the division
        bits_x = bits_y = 0ULL;
        for (int k = k0; k < k1; ++k) {
          const bool first = k < y;
          const int rc = list[first ? x + 1 + k : k + 1];
          if (suppresses(first ? px : py, first ? ax : ay, cb[rc], ca[rc], thresh, zero_hit))
            (first ? bits_x : bits_y) |= 1ULL << rc;
        }
      }
      tpart[warp * kBits + rx] = rx == ry ? bits_x | bits_y : bits_x;
      if (ry != rx) tpart[warp * kBits + ry] = bits_y;
    }
    __syncthreads();

    // 2. resolve in every warp (no barrier hands the answer on), lane l
    // holding rows l and l + 32: alive = base & ~OR(rows of alive ranks)
    // until it stops changing. A row only sets bits above its own rank, so
    // one more rank is final each round and the fixpoint is the greedy
    // answer; a row outside `base` is stale, and never alive.
    unsigned long long lo_row = 0ULL, hi_row = 0ULL;
#pragma unroll
    for (int q = 0; q < kLaneWarps; ++q) {
      lo_row |= tpart[q * kBits + l];
      hi_row |= tpart[q * kBits + l + 32];
    }
    unsigned long long alive = base;
    for (int round = 0; round <= kBits; ++round) {
      const unsigned long long mine = (((alive >> l) & 1ULL) ? lo_row : 0ULL) |
                                      (((alive >> (l + 32)) & 1ULL) ? hi_row : 0ULL);
      const unsigned long long sup =
          ((unsigned long long)__reduce_or_sync(0xffffffffu, (unsigned int)(mine >> 32))
           << 32) |
          __reduce_or_sync(0xffffffffu, (unsigned int)mine);
      const unsigned long long next = base & ~sup;
      if (next == alive) break;
      alive = next;
    }
    for (int r = t; r < n; r += kLaneThreads) kp[c0 + r] = (uint8_t)((alive >> r) & 1ULL);

    // 3. the kept rows against the later ranks still alive: one item is a
    // kept row and a later 32-rank word that holds a live rank, 32
    // independent tests; the items of a warp share their word where they
    // can (the column boxes are then one broadcast), and a hit word is
    // ORed into `removed` by a shared-memory atomic
    const unsigned int kept_lo = (unsigned int)alive, kept_hi = (unsigned int)(alive >> 32);
    const int n_lo = __popc(kept_lo);
    const int n_kept = n_lo + __popc(kept_hi);
    const int v0 = 2 * (w + 1);  // the first later word
    for (int it = t; it < n_kept * (v_end - v0); it += kLaneThreads) {
      const int v = v0 + it / n_kept;
      const int r = it % n_kept;  // the r-th kept row of the chunk
      const unsigned int live = vbits[v] & ~*(volatile unsigned int*)&removed[v];
      if (live == 0u) continue;
      const int i = r < n_lo ? __fns(kept_lo, 0, r + 1) : 32 + __fns(kept_hi, 0, r - n_lo + 1);
      const float4 p = cb[i];
      const float pa = ca[i];
      const float4* qb = box + v * 32;
      const float* qa = ar + v * 32;
      unsigned int hits = 0u;
      bool open = false;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        hits |= (unsigned int)k2_hit(p, pa, qb[c], qa[c], t1, t_next, open) << c;
      if (open) {  // rare: these tests again, by the division
        hits = 0u;
        for (int c = 0; c < 32; ++c)
          hits |= (unsigned int)suppresses(p, pa, qb[c], qa[c], thresh, zero_hit) << c;
      }
      if (hits & live) atomicOr(&removed[v], hits & live);
    }
    __syncthreads();
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
    const float aa = box_area(a.x, a.y, a.z, a.w);
    // all 32 columns, then keep those past the diagonal and inside N
    // (the others read stale shared memory, harmlessly)
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bool hit = suppresses(a, aa, cbox[k0 + c], car[k0 + c], thresh, zero_hit);
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
  const int W = (K + kBits - 1) / kBits;
  const size_t smem = (size_t)W * kBits * (sizeof(float4) + sizeof(float)) +
                      kLaneWarps * kBits * (sizeof(unsigned long long) + 1) +
                      (size_t)4 * W * sizeof(unsigned int);
  // the bounds of the division-free test (k2_hit): t and the float after
  // it, for t in [2^-60, 2^60); -inf and NaN (every test divides) otherwise
  const bool covered = thresh >= 0x1p-60f && thresh < 0x1p60f;
  const float t1 = covered ? thresh : -INFINITY;
  const float t_next = covered ? std::nextafter(thresh, INFINITY) : NAN;
  perclass_nms_kernel<<<lanes, kLaneThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, thresh, t1, t_next);
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
