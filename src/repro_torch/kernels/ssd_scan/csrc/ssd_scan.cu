// Mamba2 SSD chunk scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan_fwd` in
// src/repro/kernels/ssd_scan/ssd_scan.py.  The same function: per (batch,
// head), for each chunk of Q positions with cum = running sum of dA over the
// chunk,
//   y     = (C B^T o L) X + (C state^T) o exp(cum),
//           L[i, j] = exp(cum_i - cum_j) for i >= j, else 0;
//   state = state * exp(cum_last) + (X o exp(cum_last - cum))^T B,
// all in fp32, returning y in x's dtype and the fp32 final state.
//
// What it is given, unlike the TPU kernel:
//   * x [B, S, H, P], dA [B, S, H] and B, C in their group layout
//     [B, S, G, N], read through strides: no transposed [B, H, C, Q, .]
//     copy and no repeat of B and C to the heads (head h reads group
//     h / (H / G)); y is written in the same layout;
//   * an optional initial state [B, H, P, N] that seeds the recurrence (the
//     JAX wrapper hands such calls to its jnp reference instead).
//
// What bounds it: operations.  Per (b, h, chunk) the TPU kernel's work is
// 2Q^2 N + 2Q^2 P + 4QPN flops on Q (P + 2N + 1) inputs, hundreds of flops
// per byte.  The TPU grid (B, H, chunks) runs in order and carries the state
// in VMEM; on Hopper the design is:
//   * one block per (P-slice of 16 state rows, head, batch), walking the
//     chunks in order with its [16, N] fp32 state slice in shared memory for
//     the whole sequence.  The P rows of the state are independent (y column
//     p needs only state[p, :] and x[:, p]), so the slices fill the card at
//     batch 1 (32 heads x 4 slices = 128 blocks for mamba2-370m) at the cost
//     of recomputing the C B^T tile once per slice;
//   * the chunk is tiled as flash attention tiles keys: 64-row tiles of C
//     and B (a whole 256 x 128 fp32 chunk of each would be 256 KB, over the
//     227 KB a block may have) staged transposed in shared memory, each
//     thread holding a 4 x 4 block of the score tile in registers; tiles
//     above the diagonal are never visited;
//   * exp(cum_i - cum_j) is taken only where i >= j (a select, never a
//     multiply by a mask: above the diagonal it overflows to inf, and
//     inf * 0 is NaN); exp(cum) and exp(cum_last - cum) are computed once
//     per chunk;
//   * the running sum of dA is taken in order, as a sequential cumsum does.
// CUDA-core fp32 FMA, no tensor cores, TMA or cp.async, and C B^T once per
// slice and head rather than once per group: this is the first, simple
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // chunk positions per tile
constexpr int kPT = 16;    // state rows (columns of y) per block
constexpr int kMaxQ = 512;
constexpr int kPad = 68;   // row stride of the transposed C and B tiles (16-byte rows)
constexpr int kSPad = 65;  // row stride of the score tile (odd: rows on distinct banks)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace

// Mirrored field for field by ctypes in ops.py.  Strides are in elements, in
// the order (batch, seq, head or group); the last dim is contiguous.
struct SsdArgs {
  int dtype;  // of x, B, C and y: 0 = float32, 1 = bfloat16
  int batch, seq, heads, groups, head_dim, d_state, chunk, has_init;
  const void* x;
  const float* dA;
  const void* B;
  const void* C;
  const float* init;   // [B, H, P, N] fp32, contiguous (has_init)
  void* y;
  float* final_state;  // [B, H, P, N] fp32, contiguous
  long long x_s[3], a_s[3], b_s[3], c_s[3], y_s[3];
  cudaStream_t stream;
};

namespace {

template <int N>
constexpr size_t smem_floats() {
  return 2 * N * kPad + N * kPT + kTile * kSPad + kTile * kPT + 3 * kMaxQ;
}

// grid (P / kPT, H, B), kThreads threads.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* s_ct = smem;                  // [N][kPad]  C tile, transposed
  float* s_bt = s_ct + N * kPad;       // [N][kPad]  B tile, transposed
  float* s_st = s_bt + N * kPad;       // [N][kPT]   the state slice, transposed
  float* s_s = s_st + N * kPT;         // [kTile][kSPad] decay-masked scores
  float* s_x = s_s + kTile * kSPad;    // [kTile][kPT]   x tile of this slice
  float* s_cum = s_x + kTile * kPT;    // [kMaxQ] cum
  float* s_ecum = s_cum + kMaxQ;       // exp(cum)
  float* s_w = s_ecum + kMaxQ;         // exp(cum_last - cum)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.heads / a.groups);
  const int Q = a.chunk;
  const int n_chunks = a.seq / Q;
  const int n_tiles = (Q + kTile - 1) / kTile;

  const T* xp = static_cast<const T*>(a.x) + b * a.x_s[0] + h * a.x_s[2] + p0;
  const float* dap = a.dA + b * a.a_s[0] + h * a.a_s[2];
  const T* bp = static_cast<const T*>(a.B) + b * a.b_s[0] + g * a.b_s[2];
  const T* cp = static_cast<const T*>(a.C) + b * a.c_s[0] + g * a.c_s[2];
  T* yp = static_cast<T*>(a.y) + b * a.y_s[0] + h * a.y_s[2] + p0;
  const long long st_off = ((static_cast<long long>(b) * a.heads + h) * a.head_dim + p0) * N;

  for (int idx = tid; idx < N * kPT; idx += kThreads) {
    const int pl = idx / N, n = idx % N;
    s_st[n * kPT + pl] = a.has_init ? a.init[st_off + idx] : 0.f;
  }

  // score tile: thread (ty, tx) owns rows ty*4.., columns tx*4..
  const int ty = tid / 16, tx = tid % 16;
  // y tile: thread owns row yr, columns yc..yc+3 of the slice
  const int yr = tid / 4, yc = (tid % 4) * 4;
  // state update: thread owns state[sp + e, sn] for e < E
  constexpr int E = kPT * N / kThreads;
  const int sn = tid % N, sp = (tid / N) * E;
  float st_acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) st_acc[e] = 0.f;

  for (int ck = 0; ck < n_chunks; ++ck) {
    const long long s0 = static_cast<long long>(ck) * Q;
    __syncthreads();  // the previous chunk's state update is done
    // cum, summed in order by one thread: the same fp32 sums as a sequential
    // cumsum, so that exp(cum_i - cum_j), whose argument reaches ~200 over a
    // chunk, carries no rounding of its own beside the plain version's
    for (int i = tid; i < Q; i += kThreads) s_cum[i] = dap[(s0 + i) * a.a_s[1]];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += s_cum[i];
        s_cum[i] = run;
      }
    }
    __syncthreads();
    {
      const float last = s_cum[Q - 1];
      for (int i = tid; i < Q; i += kThreads) {
        s_ecum[i] = expf(s_cum[i]);
        s_w[i] = expf(last - s_cum[i]);
      }
    }
    __syncthreads();

    for (int ti = 0; ti < n_tiles; ++ti) {
      const int i0 = ti * kTile;
      for (int idx = tid; idx < kTile * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        const int i = i0 + r;
        s_ct[n * kPad + r] = i < Q ? to_float(cp[(s0 + i) * a.c_s[1] + n]) : 0.f;
      }
      __syncthreads();

      // the carried-in state: y_i = exp(cum_i) * sum_n C[i, n] state[p, n]
      float yacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float c = s_ct[n * kPad + yr];
        const float4 st = *reinterpret_cast<const float4*>(s_st + n * kPT + yc);
        yacc[0] = fmaf(c, st.x, yacc[0]);
        yacc[1] = fmaf(c, st.y, yacc[1]);
        yacc[2] = fmaf(c, st.z, yacc[2]);
        yacc[3] = fmaf(c, st.w, yacc[3]);
      }
      {
        const float ec = i0 + yr < Q ? s_ecum[i0 + yr] : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) yacc[k] *= ec;
      }

      const bool last_tile = ti == n_tiles - 1;
      for (int tj = 0; tj <= ti; ++tj) {
        const int j0 = tj * kTile;
        for (int idx = tid; idx < kTile * N; idx += kThreads) {
          const int r = idx / N, n = idx % N;
          const int j = j0 + r;
          s_bt[n * kPad + r] = j < Q ? to_float(bp[(s0 + j) * a.b_s[1] + n]) : 0.f;
        }
        for (int idx = tid; idx < kTile * kPT; idx += kThreads) {
          const int r = idx / kPT, pl = idx % kPT;
          const int j = j0 + r;
          s_x[idx] = j < Q ? to_float(xp[(s0 + j) * a.x_s[1] + pl]) : 0.f;
        }
        __syncthreads();

        // S[i, j] = (C_i . B_j) exp(cum_i - cum_j) where j <= i < Q, else 0
        {
          float acc[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 4
          for (int k = 0; k < N; ++k) {
            const float4 cv = *reinterpret_cast<const float4*>(s_ct + k * kPad + ty * 4);
            const float4 bv = *reinterpret_cast<const float4*>(s_bt + k * kPad + tx * 4);
            const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
            const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(c4[u], b4[v], acc[u][v]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + ty * 4 + u;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int j = j0 + tx * 4 + v;
              float sv = 0.f;
              if (j <= i && i < Q) sv = acc[u][v] * expf(s_cum[i] - s_cum[j]);
              s_s[(ty * 4 + u) * kSPad + tx * 4 + v] = sv;
            }
          }
        }
        __syncthreads();

        // y_i += S X_j
#pragma unroll 8
        for (int jj = 0; jj < kTile; ++jj) {
          const float sv = s_s[yr * kSPad + jj];
          const float4 xv = *reinterpret_cast<const float4*>(s_x + jj * kPT + yc);
          yacc[0] = fmaf(sv, xv.x, yacc[0]);
          yacc[1] = fmaf(sv, xv.y, yacc[1]);
          yacc[2] = fmaf(sv, xv.z, yacc[2]);
          yacc[3] = fmaf(sv, xv.w, yacc[3]);
        }
        // the chunk's own contribution to the state: the last row tile
        // visits every key tile once
        if (last_tile) {
          for (int jj = 0; jj < kTile; ++jj) {
            const int j = j0 + jj;
            if (j >= Q) break;
            const float wb = s_w[j] * s_bt[sn * kPad + jj];
#pragma unroll
            for (int e = 0; e < E; ++e) st_acc[e] = fmaf(wb, s_x[jj * kPT + sp + e], st_acc[e]);
          }
        }
        __syncthreads();
      }

      const int i = i0 + yr;
      if (i < Q) {
        T* out = yp + (s0 + i) * a.y_s[1] + yc;
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k] = from_float<T>(yacc[k]);
      }
    }

    // state <- state * exp(cum_last) + the chunk's contribution.  Each entry
    // has one owner, and the barrier that ended the last key tile ordered
    // every read of the old state before this.
    const float decay = s_ecum[Q - 1];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float* s = s_st + sn * kPT + sp + e;
      *s = fmaf(*s, decay, st_acc[e]);
      st_acc[e] = 0.f;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * kPT; idx += kThreads) {
    const int pl = idx / N, n = idx % N;
    a.final_state[st_off + idx] = s_st[n * kPT + pl];
  }
}

template <typename T, int N>
int launch(const SsdArgs* a) {
  const size_t smem = smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a->head_dim / kPT, a->heads, a->batch);
  ssd_scan_kernel<T, N><<<grid, kThreads, smem, a->stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_state(const SsdArgs* a) {
  switch (a->d_state) {
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return -1;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch, or -1 for a shape this build
// has no instance for (the wrapper checks that first).
extern "C" int ssd_scan_launch(const SsdArgs* a) {
  if (a->head_dim % kPT || a->chunk > kMaxQ || a->chunk <= 0 || a->seq % a->chunk ||
      a->groups <= 0 || a->heads % a->groups)
    return -1;
  switch (a->dtype) {
    case 0: return dispatch_state<float>(a);
    case 1: return dispatch_state<__nv_bfloat16>(a);
    default: return -1;
  }
}
