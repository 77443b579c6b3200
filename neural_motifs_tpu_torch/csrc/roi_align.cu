// RoIAlign forward (TF crop_and_resize semantics) and its backward for
// Hopper.
//
// Replaces the Pallas TPU kernel neural_motifs_tpu/ops/pallas_roi_align.py
// (pallas_roi_align / _pallas_forward / _kernel). The TPU kernel evaluates
// the crop as one GEMM per 32-RoI tile against the Kronecker interpolation
// matrix (R_y (x) R_x) built in VMEM; on a GPU that matrix is 98% zeros and
// the GEMM would spend its time on them. Each output value needs only the
// 4 feature cells around its sample point, so the kernels gather and lerp.
//
// What bounds it on the card: the output. At the detector's 1000 RoIs a
// 4-image [37, 37, 512] bf16 map gives 200.7 MB of crops against 5.6 MB of
// map, so the least time is the HBM write (~60 us at 3.35 TB/s). Gathering
// the 4 taps of every output value straight from device memory reads 4x
// the output (~800 MB) through L2 in 2-byte pieces, and L2, not HBM, sets
// the pace. So:
//
//   roi_align_smem_kernel (the path of every map whose 8-channel slice
//     fits in shared memory: H*W up to 12 800 cells in bf16, 6 400 in f32):
//     one block per (image, channel slice, group of RoIs). It copies the
//     [H, W, cs] slice of its image's map into shared memory once (16-byte
//     cp.async where the map is 16-byte aligned and C a multiple of 16
//     bytes, else element by element), cs the widest of 64/32/16/8 channels
//     whose slice fits in 100 KB (two blocks an SM); the RoI groups are
//     sized so the blocks fill the SMs in one wave. Threads compute each
//     RoI's P y-taps and P x-taps once into shared memory, then each
//     thread owns one (x sample, 16-byte channel vector) of a RoI and walks
//     its P rows: 4 16-byte gathers from shared memory, the lerps in f32,
//     one 16-byte store (8 bf16 or 4 f32 channels; element stores where C
//     is not a multiple of 16 bytes). Device-memory reads are the slices
//     (~22 MB over the blocks at the main path), writes the output once.
//   roi_align_fwd_kernel (maps too large for that, e.g. 128x128): one block
//     per (image, RoI, sample row), threads striding over the channels,
//     the 4 taps read from device memory.
//
// Sample coordinates follow interp_matrix (ops/roi_align.py) exactly:
// u = lo + p * step, step = (hi - lo) / (P - 1), lo/hi = box edge * scale,
// tent weights max(0, 1 - |u - c|) on the two neighbouring cells, zero
// weight when u is outside [0, G-1]; an invalid RoI gives zeros. The
// coordinates, weights and the accumulation are f32; the store is in the
// feature map's type (f32 or bf16), rounded once.
//
// The backward (the map's gradient; the boxes get none, as in the Pallas
// kernel's custom_vjp `_bwd` and the reference's roi_align_kernel.cu): each
// upstream gradient value, times its tap weights, is added into the 4 cells
// the forward read it from, with the forward's taps (an invalid RoI, or a
// sample outside the map, adds nothing). Two paths, as for the forward:
//
//   roi_align_bwd_smem_kernel (every map whose 32-channel accumulator fits
//     in shared memory: up to ~1 400 cells, rows of at most 128 cells and
//     P up to 8, as the detector's 37x37 maps and 7x7 crops): the forward's
//     roi_align_smem_kernel turned around. One block per (image, 32-channel
//     slice) owns the [H, W, 32] slice of that image's gradient alone, as
//     an f32 accumulator in shared memory; no two blocks write one address,
//     so there are no device-memory atomics, no zero-fill of a device
//     buffer and no cast pass: the block zeroes its accumulator, adds every
//     RoI's gradient into it, and writes the slice once in the map's type
//     (rounded once from f32, 16-byte stores where C and the pointer allow).
//     Hopper has no native shared-memory f32 add: ptxas turns atomicAdd on
//     a shared float into a compare-and-swap loop (ATOMS.CAST.SPIN,
//     chip_smoke.py phase 2 shows it), and so is a 64-bit integer one. So
//     the adds are plain loads, adds and stores, each (map row, band of 8
//     cells) under a lock that a warp takes with integer compare-and-swap
//     (native). A warp works one RoI at a time (the RoIs sorted by height,
//     each warp a run of them, so that warps running at one time mostly
//     touch different rows): its lanes compute the RoI's taps and distinct
//     x cells, lane (cell, channel half) sums tx.w * g over the samples of
//     its cell from a row of g staged in shared memory (16-byte loads, one
//     row ahead), then adds ty.w times that sum to its cells of the row's
//     two map rows. What bounds it at the training shape (6 images, 256
//     RoIs, a [37, 37, 512] bf16 map): not the 77 MB stream of g (23 us at
//     3.35 TB/s) but each warp's chain of dependent steps a sample row
//     (shared-memory round trips, warp syncs, the lock): the block takes
//     about as long as its longest run of RoIs, so the 32-channel slice (32
//     warps, 8 RoIs each, one block an SM) is the one slice width.
//   roi_align_bwd_kernel (maps whose accumulator does not fit, e.g.
//     128x128, or P above 8; and the scatter path that roi_align_bwd_cuda's
//     `_scatter=True` forces): one block per (image, RoI, sample row),
//     threads striding over (x sample, channel); each thread adds its value
//     into the 4 cells of a zero-filled f32 [B, H, W, C] device buffer with
//     atomicAdd, then cast_bf16_kernel rounds the sums once to the map's
//     type (bf16 maps only; an f32 map's gradient is the buffer itself). At
//     the training shape its 154 M device-memory atomics land on 0.7 M
//     cells, ~220 an address, and the L2's atomic units, not HBM, set its
//     pace.
//
// nm_roi_align_bwd_smem_fits gives the dispatch: the shared-memory kernel
// wherever its accumulator fits, else the scatter path. Both paths sum in
// an order that changes from run to run (locks and atomics), so two runs
// agree to f32 rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T: VEC values, unpacked to f32 and packed back (bf16 with
// round-to-nearest-even, as __float2bfloat16).
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int VEC = 4;
  __device__ static void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void unpack2(unsigned int x, float* f) {
    f[0] = __uint_as_float(x << 16);
    f[1] = __uint_as_float(x & 0xffff0000u);
  }
  __device__ static unsigned int pack2(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned int*>(&h);
  }
  __device__ static void unpack(uint4 u, float* f) {
    unpack2(u.x, f);
    unpack2(u.y, f + 2);
    unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// The two cells that sample p of an axis touches, and their weights.
struct Tap {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Tap axis_tap(float lo, float hi, int p, int P,
                                        int G) {
  const float step = __fdiv_rn(__fsub_rn(hi, lo), (float)(P - 1));
  const float u = __fadd_rn(lo, __fmul_rn((float)p, step));
  Tap t{0, 0, 0.f, 0.f};
  if (!(u >= 0.f && u <= (float)(G - 1))) return t;  // zero extrapolation
  const float c0 = floorf(u);
  t.i0 = (int)c0;
  t.w0 = fmaxf(0.f, 1.f - fabsf(u - c0));
  if (t.i0 + 1 <= G - 1) {
    t.i1 = t.i0 + 1;
    t.w1 = fmaxf(0.f, 1.f - fabsf(u - (c0 + 1.f)));
  } else {
    t.i1 = t.i0;  // u == G-1 exactly: the right neighbour does not exist
  }
  return t;
}

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ fmap,
                                     const float* __restrict__ rois,
                                     const uint8_t* __restrict__ valid,
                                     T* __restrict__ out, int H, int W, int C,
                                     int R, int P, float scale) {
  const int py = blockIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t roi = (int64_t)b * R + r;
  const float* box = rois + roi * 4;
  T* o = out + (roi * P + py) * (int64_t)P * C;  // the [P, C] output row

  Tap ty = axis_tap(__fmul_rn(box[1], scale), __fmul_rn(box[3], scale), py, P,
                    H);
  if (!valid[roi]) {
    ty.w0 = 0.f;
    ty.w1 = 0.f;
  }
  const float x_lo = __fmul_rn(box[0], scale);
  const float x_hi = __fmul_rn(box[2], scale);
  const T* f = fmap + (int64_t)b * H * W * C;
  const T* row0 = f + (int64_t)ty.i0 * W * C;
  const T* row1 = f + (int64_t)ty.i1 * W * C;

  for (int px = 0; px < P; ++px) {
    const Tap tx = axis_tap(x_lo, x_hi, px, P, W);
    const int64_t c0 = (int64_t)tx.i0 * C;
    const int64_t c1 = (int64_t)tx.i1 * C;
    T* dst = o + (int64_t)px * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float top = tx.w0 * load_f(row0 + c0 + c) +
                        tx.w1 * load_f(row0 + c1 + c);
      const float bot = tx.w0 * load_f(row1 + c0 + c) +
                        tx.w1 * load_f(row1 + c1 + c);
      store_f(dst + c, ty.w0 * top + ty.w1 * bot);
    }
  }
}

constexpr int kThreads = 256;
constexpr size_t kSliceBudget = 100 * 1024;  // two blocks an SM
constexpr size_t kSliceMax = 200 * 1024;     // one block an SM

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned int dst =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// grid: B * slices * groups blocks. vec_in: 16-byte copies of the map are
// aligned; vec_out: 16-byte stores of the output are aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_align_smem_kernel(const T* __restrict__ fmap,
                          const float* __restrict__ rois,
                          const uint8_t* __restrict__ valid,
                          T* __restrict__ out, int H, int W, int C, int R,
                          int P, float scale, int cs, int groups, int vec_in,
                          int vec_out) {
  constexpr int VEC = Vec16<T>::VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cells = H * W;
  T* slice = reinterpret_cast<T*>(smem_raw);  // [cells][cs]
  Tap* taps = reinterpret_cast<Tap*>(
      smem_raw + (((size_t)cells * cs * sizeof(T) + 15) & ~(size_t)15));

  const int slices = (C + cs - 1) / cs;
  const int g = blockIdx.x % groups;
  const int s = (blockIdx.x / groups) % slices;
  const int b = blockIdx.x / groups / slices;
  const int c0 = s * cs;
  const int cw = min(cs, C - c0);
  const int t = threadIdx.x;

  // the [H, W, cw] slice of image b, row stride cs in shared memory
  const T* src = fmap + (int64_t)b * cells * C + c0;
  if (vec_in) {
    const int nv = cw / VEC;
    for (int e = t; e < cells * nv; e += kThreads) {
      const int cell = e / nv;
      const int j = e - cell * nv;
      cp_async16(slice + cell * cs + j * VEC, src + (int64_t)cell * C + j * VEC);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    for (int e = t; e < cells * cw; e += kThreads) {
      const int cell = e / cw;
      const int c = e - cell * cw;
      slice[cell * cs + c] = src[(int64_t)cell * C + c];
    }
  }

  // this block's RoIs; a pass covers rpp RoIs, a thread one (x sample,
  // channel vector) of one RoI and all P of its rows
  const int per = (R + groups - 1) / groups;
  const int r_begin = g * per;
  const int r_end = min(R, r_begin + per);
  const int nvec = (cw + VEC - 1) / VEC;
  const int row_items = P * nvec;
  const int rpp = kThreads / row_items;
  const int rl = t / row_items;
  const int px = (t - rl * row_items) / nvec;
  const int j = t - rl * row_items - px * nvec;
  const int ch = j * VEC;  // first channel of this thread's vector

  for (int r0 = r_begin; r0 < r_end; r0 += rpp) {
    const int nb = min(rpp, r_end - r0);
    __syncthreads();  // the slice is in; the last pass's taps are read
    for (int k = t; k < nb * 2 * P; k += kThreads) {  // taps [nb][y, x][P]
      const int q = k / (2 * P);
      const int axis = (k - q * 2 * P) / P;  // 0: y, 1: x
      const int p = k - q * 2 * P - axis * P;
      const int64_t roi = (int64_t)b * R + r0 + q;
      const float* box = rois + roi * 4;
      Tap tp;
      if (axis == 0) {
        tp = axis_tap(__fmul_rn(box[1], scale), __fmul_rn(box[3], scale), p,
                      P, H);
        if (!valid[roi]) {
          tp.w0 = 0.f;
          tp.w1 = 0.f;
        }
      } else {
        tp = axis_tap(__fmul_rn(box[0], scale), __fmul_rn(box[2], scale), p,
                      P, W);
      }
      taps[k] = tp;
    }
    __syncthreads();
    if (rl >= nb) continue;

    const Tap tx = taps[(rl * 2 + 1) * P + px];
    const T* col0 = slice + tx.i0 * cs + ch;
    const T* col1 = slice + tx.i1 * cs + ch;
    const int64_t roi = (int64_t)b * R + r0 + rl;
    T* dst = out + (roi * P * P + px) * C + c0 + ch;  // row py = 0
    for (int py = 0; py < P; ++py, dst += (int64_t)P * C) {
      const Tap ty = taps[(rl * 2) * P + py];
      float v00[VEC], v01[VEC], v10[VEC], v11[VEC], res[VEC];
      Vec16<T>::unpack(*reinterpret_cast<const uint4*>(col0 + ty.i0 * W * cs), v00);
      Vec16<T>::unpack(*reinterpret_cast<const uint4*>(col1 + ty.i0 * W * cs), v01);
      Vec16<T>::unpack(*reinterpret_cast<const uint4*>(col0 + ty.i1 * W * cs), v10);
      Vec16<T>::unpack(*reinterpret_cast<const uint4*>(col1 + ty.i1 * W * cs), v11);
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float top = tx.w0 * v00[c] + tx.w1 * v01[c];
        const float bot = tx.w0 * v10[c] + tx.w1 * v11[c];
        res[c] = ty.w0 * top + ty.w1 * bot;
      }
      if (vec_out && ch + VEC <= cw) {
        *reinterpret_cast<uint4*>(dst) = Vec16<T>::pack(res);
      } else {
        for (int c = 0; c < VEC && ch + c < cw; ++c) store_f(dst + c, res[c]);
      }
    }
  }
}

// The channel slice of the shared-memory path, or 0 where the map is too
// large for it (or P too large for one pass of a block).
int pick_slice(int H, int W, int C, int P, size_t elem, int vec) {
  const size_t cells = (size_t)H * W;
  const int widths[] = {64, 32, 16, 8};
  int cs = 0;
  for (int c : widths) {
    if (cells * c * elem <= kSliceBudget) {
      cs = c;
      break;
    }
  }
  if (!cs && cells * 8 * elem <= kSliceMax) cs = 8;
  while (cs > 8 && cs / 2 >= C) cs /= 2;  // no wider than the channels
  if (cs && P * ((cs + vec - 1) / vec) > kThreads) cs = 0;
  return cs;
}

// The launch settings of a shared-memory kernel (roi_align_smem_kernel<T>,
// roi_align_bwd_smem_kernel<TG, TO>) on the current device, found once per
// kernel, device and shared-memory size (the host-side calls below
// would otherwise cost every launch of a launch-bound path): the opt-in
// shared-memory limit raised to `smem`, the SM count, the blocks an SM
// holds at `smem`.
constexpr int kMaxDevices = 64;

template <auto Kernel, int Threads = kThreads>
cudaError_t smem_launch_config(size_t smem, int* sms, int* per_sm) {
  struct Config {
    size_t smem_limit = 0, occ_smem = 0;
    int sms = 0, per_sm = 0;
  };
  static std::mutex mu;
  static Config configs[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Config& c = configs[dev];
  if (c.sms == 0) {
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (smem > c.smem_limit) {
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    c.smem_limit = smem;
  }
  if (smem != c.occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c.per_sm, Kernel, Threads, smem);
    if (err != cudaSuccess) return err;
    c.occ_smem = smem;
  }
  *sms = c.sms;
  *per_sm = c.per_sm;
  return cudaSuccess;
}

template <typename T>
int launch(const T* fmap, const float* rois, const uint8_t* valid, T* out,
           int B, int H, int W, int C, int R, int P, float scale,
           cudaStream_t s) {
  constexpr int VEC = Vec16<T>::VEC;
  const int cs = pick_slice(H, W, C, P, sizeof(T), VEC);
  if (!cs) {
    const dim3 grid(P, R, B);
    const int threads = C >= 128 ? 128 : ((C + 31) / 32) * 32;
    roi_align_fwd_kernel<T><<<grid, threads, 0, s>>>(fmap, rois, valid, out,
                                                     H, W, C, R, P, scale);
    return (int)cudaGetLastError();
  }
  const int slices = (C + cs - 1) / cs;
  // the taps of the most RoIs a pass can take (a one-vector slice)
  const size_t slice_bytes = ((size_t)H * W * cs * sizeof(T) + 15) & ~(size_t)15;
  const size_t smem = slice_bytes + (size_t)(kThreads / P) * 2 * P * sizeof(Tap);
  int sms = 0, per_sm = 0;
  const cudaError_t err =
      smem_launch_config<roi_align_smem_kernel<T>>(smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  // RoI groups: as many as fill the SMs in one wave, at least one
  const int64_t pairs = (int64_t)B * slices;
  const int64_t slots = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  int groups = (int)(slots / pairs);
  groups = groups < 1 ? 1 : (groups > R ? R : groups);
  const int vec_in = (C % VEC == 0) && (reinterpret_cast<uintptr_t>(fmap) % 16 == 0);
  const int vec_out = (C % VEC == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  roi_align_smem_kernel<T><<<(unsigned int)(pairs * groups), kThreads, smem, s>>>(
      fmap, rois, valid, out, H, W, C, R, P, scale, cs, groups, vec_in,
      vec_out);
  return (int)cudaGetLastError();
}

constexpr int kBwdThreads = 128;
constexpr int kBwdMaxP = 64;

// grid: (R * P, B) blocks; the gradient of crop row (b, r, py) into acc.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    roi_align_bwd_kernel(const T* __restrict__ g,
                         const float* __restrict__ rois,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ acc, int H, int W, int C, int R,
                         int P, float scale) {
  __shared__ Tap tx[kBwdMaxP];
  const int r = blockIdx.x / P;
  const int py = blockIdx.x - r * P;
  const int b = blockIdx.y;
  const int64_t roi = (int64_t)b * R + r;
  if (!valid[roi]) return;  // uniform over the block
  const float* box = rois + roi * 4;
  const Tap ty =
      axis_tap(__fmul_rn(box[1], scale), __fmul_rn(box[3], scale), py, P, H);
  if (ty.w0 == 0.f && ty.w1 == 0.f) return;  // the row lies outside the map
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    tx[p] = axis_tap(__fmul_rn(box[0], scale), __fmul_rn(box[2], scale), p, P,
                     W);
  }
  __syncthreads();

  const T* grow = g + (roi * P + py) * (int64_t)P * C;  // the [P, C] row
  float* f = acc + (int64_t)b * H * W * C;
  float* row0 = f + (int64_t)ty.i0 * W * C;
  float* row1 = f + (int64_t)ty.i1 * W * C;
  for (int e = threadIdx.x; e < P * C; e += blockDim.x) {
    const int px = e / C;
    const int c = e - px * C;
    const Tap t = tx[px];
    const float v = load_f(grow + e);
    // the forward's ty.w * (tx.w * v) taps, transposed
    const float v0 = t.w0 * v;
    const float v1 = t.w1 * v;
    const int64_t c0 = (int64_t)t.i0 * C + c;
    const int64_t c1 = (int64_t)t.i1 * C + c;
    if (ty.w0 != 0.f) {
      if (t.w0 != 0.f) atomicAdd(row0 + c0, ty.w0 * v0);
      if (t.w1 != 0.f) atomicAdd(row0 + c1, ty.w0 * v1);
    }
    if (ty.w1 != 0.f) {
      if (t.w0 != 0.f) atomicAdd(row1 + c0, ty.w1 * v0);
      if (t.w1 != 0.f) atomicAdd(row1 + c1, ty.w1 * v1);
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ in,
                                 __nv_bfloat16* __restrict__ out, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    out[i] = __float2bfloat16(in[i]);
  }
}

// roi_align_bwd_smem_kernel's settings: its channel slice; its threads, 32
// warps (one block an SM: the 175 KB accumulator of a 37x37 map leaves no
// room for a second); the floats a sample takes in a warp's row buffer (the
// slice and 4 of padding: the 16-byte reads of 8 lanes at 8 different
// samples hit 8 distinct bank groups); the most samples a crop row has (its
// 2 * kBwdRow x cells fill a warp's 16 cell lanes); the cells a lock covers
// in a map row and the most bands a row has (a row pair of a RoI then
// needs at most 32 locks, one a lane); the most RoIs of an image a block
// sorts by height; the most shared memory a block can opt into on Hopper.
constexpr int kBwdCS = 32;
constexpr int kBwdSmemThreads = 1024;
constexpr int kBwdWarps = kBwdSmemThreads / 32;
constexpr int kBwdBufStride = kBwdCS + 4;
constexpr int kBwdRow = 8;
constexpr int kBwdBand = 8;
constexpr int kBwdMaxBands = 16;
constexpr int kBwdSortMax = 256;
constexpr size_t kSmemOptin = 232448;

// A RoI's x cell: the cell, the first and last sample px that touch it
// (neighbours), and the tap weights of px = pa and pa + 1.
struct XCell {
  int x, pa, pb;
  float wa, wb;
};

__host__ __device__ inline int bwd_bands(int W) { return (W + kBwdBand - 1) / kBwdBand; }

// The shared memory of roi_align_bwd_smem_kernel: the f32 accumulator
// [cells][kBwdCS], a lock per (map row, band), the RoIs' sort keys and order
// [kBwdSortMax], and each warp's row of g [P][kBwdBufStride] (f32), taps
// [2P] and x cells [2 * kBwdRow] of its RoI.
size_t bwd_smem_bytes(int H, int W, int P) {
  const size_t acc = ((size_t)H * W * kBwdCS * sizeof(float) + 15) & ~(size_t)15;
  const size_t locks = ((size_t)H * bwd_bands(W) * sizeof(int) + 15) & ~(size_t)15;
  return acc + locks + kBwdSortMax * (sizeof(float) + sizeof(int)) +
         (size_t)kBwdWarps * (P * kBwdBufStride * sizeof(float) +
                              2 * P * sizeof(Tap) + 2 * kBwdRow * sizeof(XCell));
}

// The word of channel ch of a cell in the accumulator: 16-byte chunks
// swizzled by the cell, so that a quarter warp's 16-byte accesses (4
// neighbouring cells x 2 channel halves) hit 8 distinct bank groups.
__device__ __forceinline__ int acc_word(int cell, int ch) {
  return cell * kBwdCS + (((ch >> 2) ^ (cell & 7)) << 2) + (ch & 3);
}

// grid: B * slices blocks, one per (image b, channel slice s); the block
// owns out[b, :, :, s*CS : s*CS + cw] as an f32 accumulator in shared
// memory. Hopper has no native shared-memory f32 add (ptxas makes
// atomicAdd a compare-and-swap loop, about one add a clock an SM), so the
// accumulator takes plain adds under a lock per (map row, band of cells).
//
// The block's RoIs are sorted by height on the map (invalid ones last), and
// each warp takes a run of them, so that warps running at one time mostly
// add to different map rows. A warp works one RoI at a time: it computes
// the RoI's 2P taps and its distinct x cells (at most 2P, found with
// __match_any_sync) into its own shared tables; lane (e, cg) = (lane / 2,
// lane % 2) takes x cell e and channel half cg (CS / 2 channels). Per
// sample row py, lanes load the row's slice of g one row ahead (16-byte
// loads) and store it in the warp's row buffer as f32; lane (e, cg) sums
// tx.w * g over the samples that touch its cell, then, holding the locks of
// the RoI's bands of map rows ty.i0 and ty.i1 (a lock covers 8 cells of a
// row; a warp takes all it needs at once or none), adds ty.w0 and ty.w1
// times the sum to its cells of those rows. The lanes of a row hit distinct
// words.
//
// A warp's run is a chain of dependent steps, so the time of a block is
// about that of its longest run: the 32-channel slice gives each image's
// RoIs to 32 warps, at the price of one block an SM.
// vec: 16-byte loads of g are aligned; vec_out: 16-byte stores of out are.
template <typename TG, typename TO>
__global__ void __launch_bounds__(kBwdSmemThreads, 1)
    roi_align_bwd_smem_kernel(const TG* __restrict__ g,
                              const float* __restrict__ rois,
                              const uint8_t* __restrict__ valid,
                              TO* __restrict__ out, int H, int W, int C,
                              int R, int P, float scale, int vec,
                              int vec_out) {
  constexpr int CS = kBwdCS;
  constexpr int BS = kBwdBufStride;
  constexpr int CL = CS / 2;         // channels a lane
  constexpr int V = Vec16<TG>::VEC;  // values of g in 16 bytes
  constexpr int U = CS / V;          // 16-byte pieces of a sample's slice
  constexpr int LD = (kBwdRow * U + 31) / 32;  // pieces a lane loads a row
  constexpr unsigned int kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cells = H * W;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  float* acc = reinterpret_cast<float*>(smem_raw);  // [cells][CS], swizzled
  unsigned char* rest =
      smem_raw + (((size_t)cells * CS * sizeof(float) + 15) & ~(size_t)15);
  const int nbands = bwd_bands(W);
  int* locks = reinterpret_cast<int*>(rest);  // [H][nbands]
  rest += ((size_t)H * nbands * sizeof(int) + 15) & ~(size_t)15;
  float* keys = reinterpret_cast<float*>(rest);  // [kBwdSortMax]
  int* order = reinterpret_cast<int*>(keys + kBwdSortMax);
  rest += kBwdSortMax * (sizeof(float) + sizeof(int));
  float* buf = reinterpret_cast<float*>(rest) + warp * P * BS;  // [P][BS]
  rest += (size_t)kBwdWarps * P * BS * sizeof(float);
  Tap* taps = reinterpret_cast<Tap*>(rest) + warp * 2 * P;  // [y, x][P]
  XCell* xcs = reinterpret_cast<XCell*>(reinterpret_cast<Tap*>(rest) +
                                        kBwdWarps * 2 * P) +
               warp * 2 * kBwdRow;
  const int e = lane >> 1;   // this lane's x cell of a RoI
  const int cg = lane & 1;   // this lane's channel half

  const int slices = (C + CS - 1) / CS;
  const int s = blockIdx.x % slices;
  const int b = blockIdx.x / slices;
  const int c0 = s * CS;
  const int cw = min(CS, C - c0);
  const int nc = min(CL, cw - cg * CL);  // this lane's channels (<= 0: none)
  for (int i = t; i < cells * CS; i += kBwdSmemThreads) acc[i] = 0.f;
  for (int i = t; i < H * nbands; i += kBwdSmemThreads) locks[i] = 0;
  // the RoIs in order of their height on the map (invalid ones last)
  const bool sorted = R <= kBwdSortMax;
  if (sorted) {
    for (int r = t; r < R; r += kBwdSmemThreads) {
      const int64_t roi = (int64_t)b * R + r;
      const float k = rois[roi * 4 + 1] + rois[roi * 4 + 3];
      keys[r] = valid[roi] && k == k ? k : INFINITY;
    }
  }
  __syncthreads();
  if (sorted) {
    for (int r = t; r < R; r += kBwdSmemThreads) {
      const float k = keys[r];
      int rank = 0;
      for (int q = 0; q < R; ++q) {
        const float kq = keys[q];
        rank += kq < k || (kq == k && q < r);
      }
      order[rank] = r;
    }
    __syncthreads();
  }

  const int run = (R + kBwdWarps - 1) / kBwdWarps;
  const int i_end = min(R, (warp + 1) * run);
  for (int i = warp * run; i < i_end; ++i) {  // the same for the warp
    const int r = sorted ? order[i] : i;
    const int64_t roi = (int64_t)b * R + r;
    __syncwarp();  // the last RoI's tables are read
    if (lane < 2 * P) {
      const float* box = rois + roi * 4;
      Tap tp;
      if (lane < P) {
        tp = axis_tap(__fmul_rn(box[1], scale), __fmul_rn(box[3], scale),
                      lane, P, H);
        if (!valid[roi]) {
          tp.w0 = 0.f;
          tp.w1 = 0.f;
        }
      } else {
        tp = axis_tap(__fmul_rn(box[0], scale), __fmul_rn(box[2], scale),
                      lane - P, P, W);
      }
      taps[lane] = tp;
    }
    __syncwarp();

    // the x cells: lane l < 2P stands for tap l & 1 of sample l >> 1; the
    // lanes of one cell are neighbours (u is monotonic in px), and the
    // lowest of them lists it
    int n;
    {
      Tap tp{0, 0, 0.f, 0.f};
      if (lane < 2 * P) tp = taps[P + (lane >> 1)];
      const int x = lane & 1 ? tp.i1 : tp.i0;
      const bool ok = lane < 2 * P && (lane & 1 ? tp.w1 : tp.w0) != 0.f;
      const unsigned int same = __match_any_sync(kAll, ok ? x : -1 - lane);
      const bool lead = ok && lane == __ffs(same) - 1;
      const unsigned int leads = __ballot_sync(kAll, lead);
      if (lead) {
        const int pa = (__ffs(same) - 1) >> 1;
        const int pb = (31 - __clz(same)) >> 1;
        const Tap ta = taps[P + pa];
        XCell xc{x, pa, pb, ta.i0 == x ? ta.w0 : ta.w1, 0.f};
        if (pb > pa) {
          const Tap tb = taps[P + pa + 1];
          xc.wb = tb.i0 == x ? tb.w0 : tb.w1;
        }
        xcs[__popc(leads & ((1u << lane) - 1))] = xc;
      }
      n = __popc(leads);
    }
    __syncwarp();
    const bool on = e < n && nc > 0;
    XCell xc{0, 0, -1, 0.f, 0.f};
    if (on) xc = xcs[e];
    // the bands of the RoI's x cells, where its rows' locks lie
    const int blo = __reduce_min_sync(kAll, e < n ? xc.x : W) / kBwdBand;
    const int nbw = __reduce_max_sync(kAll, e < n ? xc.x : 0) / kBwdBand - blo + 1;
    unsigned int backoff = 2654435761u * (blockIdx.x * kBwdWarps + warp + 1);

    // the rows of g: lane l loads pieces k = l * LD + j (16 bytes of
    // sample k / U, channels (k % U) * V on) one row ahead, and at the
    // row's start stores them in the warp's buffer as f32 (element loads,
    // not ahead, where 16-byte ones are not aligned)
    const TG* src = g + roi * P * P * C + c0;  // sample (0, 0)
    const int64_t row_step = (int64_t)P * C;
    uint4 raw[LD];
    auto piece_on = [&](int k) { return k < P * U && (k % U) * V < cw; };
    auto stage = [&](int py) {
      if (!vec) return;
#pragma unroll
      for (int j = 0; j < LD; ++j) {
        const int k = lane * LD + j;
        if (piece_on(k)) {
          raw[j] = __ldg(reinterpret_cast<const uint4*>(
              src + py * row_step + (int64_t)(k / U) * C + (k % U) * V));
        }
      }
    };
    auto skip = [&](int py) {  // an invalid RoI, or a row outside the map
      return taps[py].w0 == 0.f && taps[py].w1 == 0.f;
    };
    int py = 0;  // the next row that adds anything
    while (py < P && skip(py)) ++py;
    if (py < P) stage(py);
    while (py < P) {
      const Tap ty = taps[py];
      __syncwarp();  // the last row's buffer is read
#pragma unroll
      for (int j = 0; j < LD; ++j) {
        const int k = lane * LD + j;
        if (piece_on(k)) {
          float f[V];
          if (vec) {
            Vec16<TG>::unpack(raw[j], f);
          } else {
            const TG* p = src + py * row_step + (int64_t)(k / U) * C + (k % U) * V;
            const int m = cw - (k % U) * V;
#pragma unroll
            for (int q = 0; q < V; ++q) f[q] = q < m ? load_f(p + q) : 0.f;
          }
          float4* d = reinterpret_cast<float4*>(buf + (k / U) * BS + (k % U) * V);
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            d[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
          }
        }
      }
      __syncwarp();
      do {
        ++py;
      } while (py < P && skip(py));
      if (py < P) stage(py);  // in flight while this row is summed and added

      // sum[c] = sum over the cell's samples of tx.w * g (channel c)
      float sum[CL];
#pragma unroll
      for (int c = 0; c < CL; ++c) sum[c] = 0.f;
      for (int px = xc.pa; px <= xc.pb; ++px) {
        float w;
        if (px - xc.pa < 2) {
          w = px == xc.pa ? xc.wa : xc.wb;
        } else {  // a cell of more samples (small RoIs)
          const Tap tp = taps[P + px];
          w = tp.i0 == xc.x ? tp.w0 : tp.w1;
        }
        const float4* v = reinterpret_cast<const float4*>(buf + px * BS + cg * CL);
#pragma unroll
        for (int c = 0; c < CL / 4; ++c) {
          const float4 f = v[c];
          sum[4 * c] += w * f.x;
          sum[4 * c + 1] += w * f.y;
          sum[4 * c + 2] += w * f.z;
          sum[4 * c + 3] += w * f.w;
        }
      }

      // add ty.w0 * sum to map row ty.i0 and ty.w1 * sum to row ty.i1 (the
      // forward's ty.w * (tx.w * v) taps, transposed), holding the locks of
      // the RoI's bands of those rows: lane k < need takes one; where any is
      // held elsewhere the warp frees those it took and tries again after a
      // pseudo-random pause, so it never waits while holding one
      const bool r0 = ty.w0 != 0.f, r1 = ty.w1 != 0.f;
      const int need = (r0 + r1) * nbw;
      int* my_lock = nullptr;
      if (lane < need) {
        const int row = r0 && lane < nbw ? ty.i0 : ty.i1;
        my_lock = locks + row * nbands + blo + lane % nbw;
      }
      while (true) {
        const bool got = !my_lock || atomicCAS(my_lock, 0, 1) == 0;
        if (__all_sync(kAll, got)) break;
        if (my_lock && got) atomicExch(my_lock, 0);
        backoff = backoff * 1664525u + 1013904223u;
        __nanosleep(32 + (backoff >> 26));
      }
      if (my_lock) __threadfence_block();
      __syncwarp();
      if (on) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (!(k ? r1 : r0)) continue;
          const float wy = k ? ty.w1 : ty.w0;
          const int cell = (k ? ty.i1 : ty.i0) * W + xc.x;
          if (nc == CL) {
#pragma unroll
            for (int c = 0; c < CL / 4; ++c) {
              float4* a = reinterpret_cast<float4*>(
                  acc + acc_word(cell, cg * CL + 4 * c));
              float4 q = *a;
              q.x += wy * sum[4 * c];
              q.y += wy * sum[4 * c + 1];
              q.z += wy * sum[4 * c + 2];
              q.w += wy * sum[4 * c + 3];
              *a = q;
            }
          } else {
#pragma unroll
            for (int c = 0; c < CL; ++c) {
              if (c < nc) acc[acc_word(cell, cg * CL + c)] += wy * sum[c];
            }
          }
        }
      }
      __syncwarp();
      if (my_lock) {
        __threadfence_block();
        atomicExch(my_lock, 0);
      }
    }
  }

  // the slice, rounded once to the map's type
  __syncthreads();
  constexpr int OVEC = Vec16<TO>::VEC;
  TO* dst = out + (int64_t)b * cells * C + c0;
  if (vec_out) {  // cw is a multiple of OVEC (4 or 8 channels)
    const int nv = cw / OVEC;
    for (int i = t; i < cells * nv; i += kBwdSmemThreads) {
      const int cell = i / nv;
      const int ch = (i - cell * nv) * OVEC;
      float f[OVEC];
#pragma unroll
      for (int u = 0; u < OVEC; u += 4) {
        const float4 q =
            *reinterpret_cast<const float4*>(acc + acc_word(cell, ch + u));
        f[u] = q.x;
        f[u + 1] = q.y;
        f[u + 2] = q.z;
        f[u + 3] = q.w;
      }
      *reinterpret_cast<uint4*>(dst + (int64_t)cell * C + ch) =
          Vec16<TO>::pack(f);
    }
  } else {
    for (int i = t; i < cells * cw; i += kBwdSmemThreads) {
      const int cell = i / cw;
      const int ch = i - cell * cw;
      store_f(dst + (int64_t)cell * C + ch, acc[acc_word(cell, ch)]);
    }
  }
}

// Whether roi_align_bwd_smem_kernel takes these shapes: its accumulator
// fits, a row has at most kBwdMaxBands bands, P at most the kBwdRow samples
// a warp holds. Else the scatter path.
bool bwd_smem_fits(int H, int W, int P) {
  return P <= kBwdRow && bwd_bands(W) <= kBwdMaxBands &&
         bwd_smem_bytes(H, W, P) <= kSmemOptin;
}

template <typename TG, typename TO>
int launch_bwd_smem(const TG* g, const float* rois, const uint8_t* valid,
                    TO* out, int B, int H, int W, int C, int R, int P,
                    float scale, cudaStream_t s) {
  if (!bwd_smem_fits(H, W, P)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(H, W, P);
  int sms = 0, per_sm = 0;
  const cudaError_t err =
      smem_launch_config<roi_align_bwd_smem_kernel<TG, TO>, kBwdSmemThreads>(
          smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  // 16-byte loads of g stay aligned where C is a multiple of 8 channels
  const int vec = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0);
  constexpr int OVEC = Vec16<TO>::VEC;
  const int vec_out = (C % OVEC == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t blocks = (int64_t)B * ((C + kBwdCS - 1) / kBwdCS);
  roi_align_bwd_smem_kernel<TG, TO><<<(unsigned int)blocks, kBwdSmemThreads, smem, s>>>(
      g, rois, valid, out, H, W, C, R, P, scale, vec, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Whether nm_roi_align_bwd's dispatch takes the shared-memory kernel for
// these shapes (1) or the scatter path (0).
extern "C" int nm_roi_align_bwd_smem_fits(int H, int W, int P) {
  return bwd_smem_fits(H, W, P);
}

// g [B, R, P, P, C] (f32, or bf16 when g_is_bf16), rois [B, R, 4] f32,
// valid [B, R] uint8 -> out [B, H, W, C] (bf16 when out_is_bf16, else f32).
// smem: the shared-memory kernel (acc unused). Else the scatter path into
// acc [B, H, W, C] f32 (zeroed here, then the sums), out = acc rounded to
// bf16 when out_is_bf16 (else out is acc).
extern "C" int nm_roi_align_bwd(const void* g, const void* rois,
                                const void* valid, void* acc, void* out,
                                int B, int H, int W, int C, int R, int P,
                                float scale, int g_is_bf16, int out_is_bf16,
                                int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)B * H * W * C;
  if (n == 0) return 0;
  if (P < 2 || P > kBwdMaxP) return (int)cudaErrorInvalidValue;
  const float* r = static_cast<const float*>(rois);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  if (smem) {
    using bf16 = __nv_bfloat16;
    if (g_is_bf16 && out_is_bf16) {
      return launch_bwd_smem(static_cast<const bf16*>(g), r, v,
                             static_cast<bf16*>(out), B, H, W, C, R, P, scale,
                             s);
    }
    if (g_is_bf16) {
      return launch_bwd_smem(static_cast<const bf16*>(g), r, v,
                             static_cast<float*>(out), B, H, W, C, R, P, scale,
                             s);
    }
    if (out_is_bf16) {
      return launch_bwd_smem(static_cast<const float*>(g), r, v,
                             static_cast<bf16*>(out), B, H, W, C, R, P, scale,
                             s);
    }
    return launch_bwd_smem(static_cast<const float*>(g), r, v,
                           static_cast<float*>(out), B, H, W, C, R, P, scale,
                           s);
  }
  if (B > 65535) return (int)cudaErrorInvalidValue;
  float* a = static_cast<float*>(acc);
  cudaError_t err = cudaMemsetAsync(a, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (R > 0) {
    const dim3 grid((unsigned int)((int64_t)R * P), (unsigned int)B);
    if (g_is_bf16) {
      roi_align_bwd_kernel<__nv_bfloat16><<<grid, kBwdThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(g), r, v, a, H, W, C, R, P, scale);
    } else {
      roi_align_bwd_kernel<float><<<grid, kBwdThreads, 0, s>>>(
          static_cast<const float*>(g), r, v, a, H, W, C, R, P, scale);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (out_is_bf16) {
    const int64_t blocks = (n + 255) / 256;
    cast_bf16_kernel<<<(unsigned int)(blocks < 4096 ? blocks : 4096), 256, 0,
                       s>>>(a, static_cast<__nv_bfloat16*>(out), n);
    err = cudaGetLastError();
  }
  return (int)err;
}

// fmap [B, H, W, C] (f32, or bf16 when is_bf16), rois [B, R, 4] f32,
// valid [B, R] uint8 -> out [B, R, P, P, C] in the fmap's type.
extern "C" int nm_roi_align_fwd(const void* fmap, const void* rois,
                                const void* valid, void* out, int B, int H,
                                int W, int C, int R, int P, float scale,
                                int is_bf16, void* stream) {
  if (B == 0 || R == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  if (is_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(fmap), r, v,
                  static_cast<__nv_bfloat16*>(out), B, H, W, C, R, P, scale,
                  s);
  }
  return launch(static_cast<const float*>(fmap), r, v,
                static_cast<float*>(out), B, H, W, C, R, P, scale, s);
}
