// One layer of the alternating highway LSTM (ops/highway_lstm.py) as one
// persistent cooperative kernel for Hopper: the whole recurrence over the
// sequence in a single launch, in place of an eager loop of ~20 launches a
// step.
//
// It replaces no Pallas kernel: the JAX package runs this recurrence as a
// lax.scan (neural_motifs_tpu/ops/highway_lstm.py) and XLA compiles it into
// one loop on the TPU. The port's eager loop launches every step's GEMM and
// elementwise ops from the host, which costs the host ~10-20 us a launch
// against a few us of device work, so the host, not the card, paced the
// context. This kernel was added for that.
//
// What bounds it on this card: operations. A step is a [B, H] x [H, 5H]
// product, 2*B*H*5H f32 operations (42 MFLOP at B 16, H 512), a dependent
// chain of T steps: ~40 us a layer at T 64 over the 67 TFLOP/s f32 peak,
// against ~20 MB of bytes a layer (~6 us at 3.35 TB/s). The design keeps
// the operands on chip so that only the operations and one barrier a step
// remain:
//   - each block owns 4 hidden units (128 blocks at H 512, at most one a
//     SM, so H <= 4 x the SM count) and keeps the 5 gate columns of W_h for
//     them ([H, 20] f32, 40 KB at H 512) in shared memory for all steps,
//     with their bias and their cell state c;
//   - a step reads h_prev [B, H] from the output itself: the carried h of a
//     row is the h it emitted at its previous real step (t - 1, or t + 1 in
//     a reversed layer), written there by its block before the last
//     barrier; it is read with ld.global.cg (from L2, past the SM's
//     incoherent L1), 16 rows at a time, into shared memory; each warp
//     takes 2 rows, each lane every 32nd k, and keeps the 2 x 20 sums in
//     registers (f32 FMAs in a fixed order); the 32 lanes' partial sums
//     are added in lane order through shared memory;
//   - the cell follows highway_lstm_gates operation for operation (each
//     product and sum rounded on its own, as the eager ops round them);
//     the block writes its slice of the output row, then all blocks meet
//     at one grid-wide barrier (cooperative_groups) a step.
// Lengths are read on the device: row b runs t = s (forward) or
// t = len_b - 1 - s (reversed layer) for s < len_b, so padded steps are
// never computed; the steps run to the batch's longest length; the output
// at t >= len_b is zero, written by the kernel. The input product
// gi = x @ W_i stays a plain GEMM before the launch.
//
// Forward only: relation training keeps the eager loop under autograd. A
// backward kernel is later work, with a benchmark cell that trains the
// relation model.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 4;   // hidden units a block
constexpr int kCols = 5 * kUnits;  // W_h columns a block: 5 gates of each unit
constexpr int kColsPad = kCols | 1;  // odd, so the 32 lanes' rows fall in 32 banks
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kTileRows = kWarps * kRowsPerWarp;  // h rows a pass
constexpr int kRedStride = 33;                    // 32 lane sums + 1 pad
constexpr int kRefused = -1;  // a shape the kernel cannot take
constexpr int kInFlight = 8;  // global loads a thread issues before it waits
static_assert(kTileRows * kUnits <= kThreads, "one cell a thread");

__host__ __device__ constexpr size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

// The shared-memory layout, in floats: W_h's columns [H][kColsPad], the h
// tile [kTileRows][H], the lane sums [kTileRows * kCols][kRedStride], the
// gates [kTileRows * kCols], the bias [kCols], the cell state [B][kUnits],
// the lengths [B] (int).
struct Layout {
  size_t w, h, red, g, bias, c, len, total;
  __host__ __device__ Layout(int B, int H) {
    w = 0;
    h = w + round4((size_t)H * kColsPad);
    red = h + round4((size_t)kTileRows * H);
    g = red + (size_t)kTileRows * kCols * kRedStride;
    bias = g + kTileRows * kCols;
    c = bias + kCols;
    len = c + (size_t)B * kUnits;
    total = len + B;
  }
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__global__ void __launch_bounds__(kThreads, 1)
highway_lstm_layer_kernel(const float* __restrict__ gi,       // [B, T, 6H]
                          const float* __restrict__ w_h,      // [H, 5H]
                          const float* __restrict__ bias,     // [5H]
                          const int64_t* __restrict__ lengths,  // [B]
                          const float* __restrict__ dmask,    // [B, H] or null
                          float* out,                         // [B, T, H]
                          int B, int T, int H, int reverse) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(B, H);
  float* w_s = smem + lay.w;
  float* h_s = smem + lay.h;
  float* red_s = smem + lay.red;
  float* g_s = smem + lay.g;
  float* b_s = smem + lay.bias;
  float* c_s = smem + lay.c;
  int* len_s = reinterpret_cast<int*>(smem + lay.len);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int j0 = blockIdx.x * kUnits;  // the block's first hidden unit

  // column n = q * kUnits + u holds gate q of unit j0 + u; kInFlight loads
  // a thread are issued before their stores, so their latencies overlap
  for (int i0 = tid; i0 < H * kCols; i0 += kThreads * kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int a = 0; a < kInFlight; ++a) {
      const int i = i0 + a * kThreads, q = (i % kCols) / kUnits, j = j0 + i % kUnits;
      v[a] = i < H * kCols && j < H ? w_h[(size_t)(i / kCols) * 5 * H + (size_t)q * H + j] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < kInFlight; ++a) {
      const int i = i0 + a * kThreads;
      if (i < H * kCols) w_s[(i / kCols) * kColsPad + i % kCols] = v[a];
    }
  }
  for (int n = tid; n < kCols; n += kThreads) {
    const int q = n / kUnits, j = j0 + n % kUnits;
    b_s[n] = j < H ? bias[(size_t)q * H + j] : 0.f;
  }
  for (int i = tid; i < B * kUnits; i += kThreads) c_s[i] = 0.f;
  for (int b = tid; b < B; b += kThreads) {
    const int64_t len = lengths[b];
    len_s[b] = (int)(len < 0 ? 0 : (len > T ? T : len));
  }
  __syncthreads();
  int steps = 0;
  for (int b = 0; b < B; ++b) steps = max(steps, len_s[b]);
  // zeros at every padded position of the block's units
  for (size_t i = tid; i < (size_t)B * T * kUnits; i += kThreads) {
    const int j = j0 + (int)(i % kUnits);
    const size_t bt = i / kUnits;
    const int t = (int)(bt % T), b = (int)(bt / T);
    if (j < H && t >= len_s[b]) out[bt * H + j] = 0.f;
  }

  cg::grid_group grid = cg::this_grid();
  const int ra = warp * kRowsPerWarp;  // the warp's first row of a tile
  // the cell of (row tid / kUnits of a tile, unit j0 + tid % kUnits), one a thread
  const int cr = tid / kUnits, cu = tid % kUnits, cj = j0 + cu;
  const bool vec = (H & 3) == 0;
  const int width = vec ? H / 4 : H, n = kTileRows * width;
  for (int s = 0; s < steps; ++s) {
    for (int r0 = 0; r0 < B; r0 += kTileRows) {
      const int rows = min(kTileRows, B - r0);
      bool live = false;  // the same in every thread
      for (int r = 0; r < rows; ++r) live |= s < len_s[r0 + r];
      if (!live) continue;
      // the cell's inputs, fetched now and used after the product
      const int cb = r0 + cr;
      const bool cell = tid < kTileRows * kUnits && cr < rows && cj < H && s < len_s[cb];
      const int ct = cell ? (reverse ? len_s[cb] - 1 - s : s) : 0;
      float gv[6], dm = 1.f;
      if (cell) {
        const float* gin = gi + ((size_t)cb * T + ct) * 6 * H + cj;
#pragma unroll
        for (int q = 0; q < 6; ++q) gv[q] = gin[(size_t)q * H];
        if (dmask != nullptr) dm = dmask[(size_t)cb * H + cj];
      }
      // h_prev, the row's output at its previous step: zero at the first
      // step, past B, and on rows that ended
      for (int i0 = tid; i0 < n; i0 += kThreads * kInFlight) {
        float4 v[kInFlight];
#pragma unroll
        for (int a = 0; a < kInFlight; ++a) {
          const int i = i0 + a * kThreads, r = i / width, b = r0 + r;
          v[a] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < n && s > 0 && r < rows && s < len_s[b]) {
            const int tp = reverse ? len_s[b] - s : s - 1;
            const float* src = out + ((size_t)b * T + tp) * H;
            if (vec) {
              v[a] = __ldcg(reinterpret_cast<const float4*>(src) + (i - r * width));
            } else {
              v[a].x = __ldcg(src + (i - r * width));
            }
          }
        }
#pragma unroll
        for (int a = 0; a < kInFlight; ++a) {
          const int i = i0 + a * kThreads;
          if (i >= n) continue;
          if (vec) {
            reinterpret_cast<float4*>(h_s)[i] = v[a];
          } else {
            h_s[i] = v[a].x;
          }
        }
      }
      __syncthreads();
      float acc[kRowsPerWarp][kCols];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[rr][c] = 0.f;
#pragma unroll 2
      for (int k = lane; k < H; k += 32) {
        float hv[kRowsPerWarp];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) hv[rr] = h_s[(ra + rr) * H + k];
        const float* wk = w_s + k * kColsPad;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float w = wk[c];
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr)
            acc[rr][c] = fmaf(hv[rr], w, acc[rr][c]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          red_s[((ra + rr) * kCols + c) * kRedStride + lane] = acc[rr][c];
      __syncthreads();
      for (int o = tid; o < kTileRows * kCols; o += kThreads) {
        const float* p = red_s + o * kRedStride;
        float sum = 0.f;
#pragma unroll
        for (int l = 0; l < 32; ++l) sum = __fadd_rn(sum, p[l]);
        g_s[o] = sum;
      }
      __syncthreads();
      if (cell) {
        const float* gh = g_s + cr * kCols + cu;  // gate q at gh[q * kUnits]
        float g[5];
#pragma unroll
        for (int q = 0; q < 5; ++q)
          g[q] = __fadd_rn(__fadd_rn(gv[q], gh[q * kUnits]), b_s[q * kUnits + cu]);
        const float in_g = sigmoid_f(g[0]);
        const float fg_g = sigmoid_f(g[1]);
        const float act = tanhf(g[2]);
        const float out_g = sigmoid_f(g[3]);
        const float r_g = sigmoid_f(g[4]);
        const float c_new = __fadd_rn(__fmul_rn(fg_g, c_s[cb * kUnits + cu]), __fmul_rn(in_g, act));
        float h_new = __fadd_rn(__fmul_rn(r_g, __fmul_rn(out_g, tanhf(c_new))),
                                __fmul_rn(__fsub_rn(1.f, r_g), gv[5]));
        if (dmask != nullptr) h_new = __fmul_rn(h_new, dm);
        c_s[cb * kUnits + cu] = c_new;
        out[((size_t)cb * T + ct) * H + cj] = h_new;
      }
      __syncthreads();  // the next tile reuses h_s, red_s and g_s
    }
    grid.sync();
  }
}

// Per device: the SM count and the opt-in shared-memory limit, the
// kernel's limit raised to it, and the blocks a SM holds at the last size
// asked (the host-side queries would otherwise cost every launch).
constexpr int kMaxDevices = 64;

cudaError_t plan(size_t smem, int blocks, bool* fits) {
  struct Config {
    int sms = 0, optin = 0, per_sm = 0;
    size_t occ_smem = 0;
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
    err = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(highway_lstm_layer_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, c.optin);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *fits = false;
  if (smem > (size_t)c.optin || blocks > c.sms) return cudaSuccess;
  if (smem != c.occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c.per_sm, highway_lstm_layer_kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    c.occ_smem = smem;
  }
  *fits = c.per_sm >= 1;
  return cudaSuccess;
}

}  // namespace

// gi [B, T, 6H] f32 (x @ W_i), w_h [H, 5H] f32, bias [5H] f32, lengths [B]
// int64, dmask [B, H] f32 or null -> out [B, T, H] f32 (uninitialised; the
// kernel writes every element). reverse: run each row from its last real
// step. Returns kRefused (-1) where H needs more blocks than the card has
// SMs (H > 4 x SMs) or their shared memory, else the launch's CUDA error.
extern "C" int nm_highway_lstm(const void* gi, const void* w_h, const void* bias,
                               const void* lengths, const void* dmask, void* out,
                               int B, int T, int H, int reverse, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  const int blocks = (H + kUnits - 1) / kUnits;
  const size_t smem = Layout(B, H).total * sizeof(float);
  bool fits = false;
  cudaError_t err = plan(smem, blocks, &fits);
  if (err != cudaSuccess) return (int)err;
  if (!fits) return kRefused;
  void* args[] = {(void*)&gi,    (void*)&w_h, (void*)&bias, (void*)&lengths,
                  (void*)&dmask, (void*)&out, (void*)&B,    (void*)&T,
                  (void*)&H,     (void*)&reverse};
  err = cudaLaunchCooperativeKernel((const void*)highway_lstm_layer_kernel, dim3(blocks),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
