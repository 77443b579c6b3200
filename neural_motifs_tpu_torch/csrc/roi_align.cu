// RoIAlign forward (TF crop_and_resize semantics) for Hopper.
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

// The launch settings of roi_align_smem_kernel<T> on the current device,
// found once per device and shared-memory size (the host-side calls below
// would otherwise cost every launch of a launch-bound path): the opt-in
// shared-memory limit raised to `smem`, the SM count, the blocks an SM
// holds at `smem`.
constexpr int kMaxDevices = 64;

template <typename T>
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
    err = cudaFuncSetAttribute(roi_align_smem_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    c.smem_limit = smem;
  }
  if (smem != c.occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c.per_sm, roi_align_smem_kernel<T>, kThreads, smem);
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
  const cudaError_t err = smem_launch_config<T>(smem, &sms, &per_sm);
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

}  // namespace

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
