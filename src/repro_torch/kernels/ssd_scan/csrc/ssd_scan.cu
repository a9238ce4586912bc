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
// What bounds it: operations.  The function needs, per (b, chunk), C B^T
// once per group on the lower triangle, and per head (C B^T o L) X, the
// chunk's state (X o w)^T B and C state^T: hundreds of flops per byte.  The
// TPU grid (B, H, chunks) runs in order and carries the state in VMEM; on
// Hopper the chunks are split apart as Mamba2's own GPU implementation does,
// into five passes, each parallel over (batch, chunk, head or group) except
// the fourth, which walks the chunks elementwise:
//   1. cum     [B, H, nC, Q]   the running sum of dA in each chunk, summed in
//              order by one thread per (b, h, chunk): the same fp32 sums as
//              a sequential cumsum, so that exp(cum_i - cum_j), whose
//              argument reaches ~200 over a chunk, carries no rounding of
//              its own (a tree scan missed the gate there);
//   2. cb      [B, nC, G, Qp, Qp]  C B^T per (b, chunk, group), lower
//              64 x 64 tiles only; Qp = Q rounded up to pass 5's 128 rows;
//   3. states  [B, nC, H, P, N]  each chunk's own state (X o w)^T B,
//              w = exp(cum_last - cum);
//   4. prev    [B, nC, H, P, N]  the state entering each chunk, walking the
//              chunks per (b, h) and state entry: prev = state, state =
//              state * exp(cum_last) + states; it is seeded with the
//              initial state and writes the final state;
//   5. y       per (b, chunk, head, 128-row tile): (CB o L) X + (C prev^T) o
//              exp(cum), key tiles above the diagonal skipped.
// The products (passes 2, 3, 5) run on the tensor cores in 3xTF32: each
// fp32 operand is split into a TF32 high part and the remainder, and a b is
// summed as a_lo b_hi + a_hi b_lo + a_hi b_hi in the fp32 accumulators
// (mma.sync m16n8k8), which keeps close to fp32 accuracy; a single TF32
// product would keep about three digits.  A warp computes 32 rows of its
// output, so that each split B fragment serves two products.  Tiles come to
// shared memory as fp32 through cp.async (bf16 inputs are converted on the
// way in), in rows padded so that every fragment load is free of bank
// conflicts.  exp(cum_i - cum_j) is taken only where i >= j (a select,
// never a multiply by a mask: above the diagonal it overflows to inf, and
// inf * 0 is NaN).  The wrapper allocates every scratch tensor; the passes
// use no atomics, so results are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_mma.cuh"

// Mirrored field for field by ctypes in ops.py.  Strides are in elements, in
// the order (batch, seq, head or group); the last dim is contiguous.  `vec`
// says that x, B and C and their strides are 16-byte aligned, so their
// rows are copied 16 bytes at a time.
struct SsdArgs {
  int dtype;  // of x, B, C and y: 0 = float32, 1 = bfloat16
  int batch, seq, heads, groups, head_dim, d_state, chunk, has_init, vec;
  const void* x;
  const float* dA;
  const void* B;
  const void* C;
  const float* init;   // [B, H, P, N] fp32, contiguous (has_init)
  void* y;             // [B, S, H, P], y_s
  float* final_state;  // [B, H, P, N] fp32, contiguous
  float* cum;          // [B, H, nC, Q]
  float* cb;           // [B, nC, G, Qp, Qp]
  float* states;       // [B, nC, H, P, N]
  float* prev;         // [B, nC, H, P, N]
  long long x_s[3], a_s[3], b_s[3], c_s[3], y_s[3];
  cudaStream_t stream;
};

// The passes, as bits of ssd_scan_launch's `passes`.
enum { kCum = 1, kCb = 2, kStates = 4, kCarry = 8, kOut = 16 };

namespace {

constexpr int kT = 64;     // chunk positions per tile
constexpr int kR = 128;    // rows of y per block of the output pass
constexpr int kP = 64;     // head_dim, the one instance
constexpr int kMaxQ = 512;
constexpr int kKT = 32;    // chunk positions per stage of the chunk-state pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; zero-filled
// when `ok` is false (src is then never read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, rows) x columns [0, cols) of a row-major source (rows `ld_src`
// elements apart) into dst (rows `ld` floats apart) as fp32; rows at or
// past `valid` are zero-filled.  With `vec` fp32 rows go through cp.async
// 16 bytes at a time and bf16 rows are read 16 bytes at a time and
// converted; otherwise element by element.
template <typename T, int NTHREADS>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, long long ld_src, int rows,
                                      int valid, int cols, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements in 16 bytes
    const int per_row = cols / E;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += NTHREADS) {
      const int r = idx / per_row, c = (idx % per_row) * E;
      const bool ok = r < valid;
      const T* s = src + (ok ? r * ld_src + c : 0);
      float* d = dst + r * ld + c;
      if constexpr (sizeof(T) == 4) {
        cp_async16(d, s, ok);
      } else {
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (ok) {
          const uint4 raw = *reinterpret_cast<const uint4*>(s);
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
        }
        *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(d + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += NTHREADS) {
      const int r = idx / cols, c = idx % cols;
      dst[r * ld + c] = r < valid ? to_float(src[r * ld_src + c]) : 0.f;
    }
  }
}

struct Shape {
  int Q, nC, nT, Qp;  // nT 64-row tiles cover the chunk; Qp rounds Q up to kR
  __device__ __forceinline__ explicit Shape(const SsdArgs& a)
      : Q(a.chunk), nC(a.seq / a.chunk), nT((a.chunk + kT - 1) / kT),
        Qp(((a.chunk + kR - 1) / kR) * kR) {}
};

// ---------------------------------------------------------------- pass 1
// One block per (32 heads, chunk, b): 64-row slices of dA [Q, 32 heads] come
// to shared memory in coalesced rows, one thread per head sums its column
// in order, and the sums leave in coalesced rows of cum.
__global__ void __launch_bounds__(256) ssd_scan_cum_kernel(const SsdArgs a) {
  __shared__ float tile[kT][33];
  const Shape sh(a);
  const int n_hg = (a.heads + 31) / 32;
  int blk = blockIdx.x;
  const int h0 = (blk % n_hg) * 32;
  blk /= n_hg;
  const int c = blk % sh.nC, b = blk / sh.nC;
  const int nh = min(32, a.heads - h0);
  const float* src = a.dA + b * a.a_s[0] + static_cast<long long>(c) * sh.Q * a.a_s[1] + h0 * a.a_s[2];
  float* dst = a.cum + (static_cast<long long>(b * a.heads + h0) * sh.nC + c) * sh.Q;
  const long long dst_h = static_cast<long long>(sh.nC) * sh.Q;  // from one head to the next
  float run = 0.f;
  for (int r0 = 0; r0 < sh.Q; r0 += kT) {
    const int rows = min(kT, sh.Q - r0);
    for (int idx = threadIdx.x; idx < kT * 32; idx += 256) {
      const int r = idx / 32, j = idx % 32;
      tile[r][j] = r < rows && j < nh ? src[(r0 + r) * a.a_s[1] + j * a.a_s[2]] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int r = 0; r < rows; ++r) {
        run += tile[r][threadIdx.x];
        tile[r][threadIdx.x] = run;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kT * 32; idx += 256) {
      const int j = idx / kT, r = idx % kT;
      if (j < nh && r < rows) dst[j * dst_h + r0 + r] = tile[r][j];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- pass 2
// One block of 4 warps per (lower tile pair, group, chunk, b); warp w owns
// rows 16w.. of the 64 x 64 tile.
template <int N>
constexpr int cb_smem_floats() {
  return 2 * kT * (N + 4);
}

template <typename T, int N>
__global__ void __launch_bounds__(128) ssd_scan_cb_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = N + 4;  // = 4 mod 32: fragment loads 4 gq + tq hit distinct banks
  float* s_c = smem;         // C rows i0.. [kT][LD]
  float* s_b = smem + kT * LD;  // B rows j0..
  const Shape sh(a);
  const int pairs = sh.nT * (sh.nT + 1) / 2;
  int blk = blockIdx.x;
  const int pr = blk % pairs;
  blk /= pairs;
  const int g = blk % a.groups;
  blk /= a.groups;
  const int c = blk % sh.nC, b = blk / sh.nC;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= pr) ++ti;
  const int tj = pr - ti * (ti + 1) / 2;
  const int i0 = ti * kT, j0 = tj * kT;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const T* cp = static_cast<const T*>(a.C) + b * a.c_s[0] + (s0 + i0) * a.c_s[1] + g * a.c_s[2];
  const T* bp = static_cast<const T*>(a.B) + b * a.b_s[0] + (s0 + j0) * a.b_s[1] + g * a.b_s[2];
  stage<T, 128>(s_c, LD, cp, a.c_s[1], kT, sh.Q - i0, N, a.vec);
  stage<T, 128>(s_b, LD, bp, a.b_s[1], kT, sh.Q - j0, N, a.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  // on the diagonal tile, column tiles right of every row of the warp are skipped
  const int n_tiles = ti == tj ? 2 * warp + 2 : 8;
  float acc[8][4];
  zero(acc);
  const float* ar = s_c + (warp * 16 + gq) * LD + tq;
#pragma unroll 2
  for (int k0 = 0; k0 < N; k0 += 8) {
    Frag af;
    af.set(ar[k0], ar[8 * LD + k0], ar[k0 + 4], ar[8 * LD + k0 + 4]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < n_tiles) {
        const float* br = s_b + (nt * 8 + gq) * LD + k0 + tq;
        mma3_rounded(acc[nt], af, BFrag(br[0], br[4]));
      }
    }
  }
  float* out = a.cb + ((static_cast<long long>(b * sh.nC + c) * a.groups + g) * sh.Qp + i0 +
                       warp * 16 + gq) * sh.Qp + j0 + 2 * tq;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    store2(out + nt * 8, acc[nt][0], acc[nt][1]);
    store2(out + 8 * sh.Qp + nt * 8, acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------- pass 3
// One block of 4 warps per (head, chunk, b): states[p, n] = sum_j x[j, p]
// w[j] B[j, n] over the chunk, kKT rows a stage in a two-stage cp.async
// ring.  Warp w owns state rows 32 (w % 2).. (two 16-row fragments, so
// that each split B fragment serves two products) and half the columns.
template <int N>
constexpr int states_smem_floats() {
  return 2 * kKT * ((kP + 8) + (N + 8)) + kMaxQ;
}

template <typename T, int N>
__global__ void __launch_bounds__(128) ssd_scan_states_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDX = kP + 8, LDB = N + 8;  // = 8 mod 32: loads 8 tq + gq are conflict-free
  constexpr int NT = N / 16;                // column tiles of 8 per warp
  float* s_x = smem;                        // [2][kKT][LDX]
  float* s_b = smem + 2 * kKT * LDX;        // [2][kKT][LDB]
  float* s_w = s_b + 2 * kKT * LDB;         // [kMaxQ] exp(cum_last - cum), 0 past Q
  const Shape sh(a);
  int blk = blockIdx.x;
  const int h = blk % a.heads;
  blk /= a.heads;
  const int c = blk % sh.nC, b = blk / sh.nC;
  const int g = h / (a.heads / a.groups);
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const T* xp = static_cast<const T*>(a.x) + b * a.x_s[0] + s0 * a.x_s[1] + h * a.x_s[2];
  const T* bp = static_cast<const T*>(a.B) + b * a.b_s[0] + s0 * a.b_s[1] + g * a.b_s[2];
  const int n_k = (sh.Q + kKT - 1) / kKT;

  stage<T, 128>(s_x, LDX, xp, a.x_s[1], kKT, sh.Q, kP, a.vec);
  stage<T, 128>(s_b, LDB, bp, a.b_s[1], kKT, sh.Q, N, a.vec);
  cp_async_commit();
  {
    const float* cum = a.cum + (static_cast<long long>(b * a.heads + h) * sh.nC + c) * sh.Q;
    const float last = cum[sh.Q - 1];
    for (int i = threadIdx.x; i < n_k * kKT; i += 128)
      s_w[i] = i < sh.Q ? expf(last - cum[i]) : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int m0 = (warp % 2) * 32, n0 = (warp / 2) * (N / 2);
  float acc[2][NT][4];
  zero(acc[0]);
  zero(acc[1]);
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      const int r0 = (kt + 1) * kKT, st = (kt + 1) % 2;
      stage<T, 128>(s_x + st * kKT * LDX, LDX, xp + r0 * a.x_s[1], a.x_s[1], kKT, sh.Q - r0, kP,
                    a.vec);
      stage<T, 128>(s_b + st * kKT * LDB, LDB, bp + r0 * a.b_s[1], a.b_s[1], kKT, sh.Q - r0, N,
                    a.vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* xs = s_x + (kt % 2) * kKT * LDX;
    const float* bs = s_b + (kt % 2) * kKT * LDB;
#pragma unroll
    for (int k0 = 0; k0 < kKT; k0 += 8) {
      const float w0 = s_w[kt * kKT + k0 + tq], w1 = s_w[kt * kKT + k0 + tq + 4];
      Frag af[2];  // A = (x o w)^T: row p, k j
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* x0 = xs + (k0 + tq) * LDX + m0 + m * 16 + gq;
        const float* x1 = x0 + 4 * LDX;
        af[m].set(x0[0] * w0, x0[8] * w0, x1[0] * w1, x1[8] * w1);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* br = bs + (k0 + tq) * LDB + n0 + nt * 8 + gq;
        const BFrag bf(br[0], br[4 * LDB]);
        mma3(acc[0][nt], af[0], bf);
        mma3(acc[1][nt], af[1], bf);
      }
    }
    __syncthreads();  // every read of this stage is done before it is refilled
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float* out = a.states +
                 ((static_cast<long long>(b * sh.nC + c) * a.heads + h) * kP + m0 + m * 16 + gq) * N +
                 n0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      store2(out + nt * 8, acc[m][nt][0], acc[m][nt][1]);
      store2(out + 8 * N + nt * 8, acc[m][nt][2], acc[m][nt][3]);
    }
  }
}

// ---------------------------------------------------------------- pass 4
// One thread per (b, h, 4 state entries), walking the chunks in order.
__global__ void __launch_bounds__(256) ssd_scan_carry_kernel(const SsdArgs a) {
  const Shape sh(a);
  const int per = a.head_dim * a.d_state / 4;
  const long long t = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (t >= static_cast<long long>(a.batch) * a.heads * per) return;
  const int e = static_cast<int>(t % per);
  const long long bh = t / per;  // b * H + h
  const int h = static_cast<int>(bh % a.heads), b = static_cast<int>(bh / a.heads);
  const long long pn = static_cast<long long>(per) * 4;
  float4 st = a.has_init ? reinterpret_cast<const float4*>(a.init + bh * pn)[e]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* __restrict__ cum = a.cum + bh * sh.nC * sh.Q + sh.Q - 1;
  const float4* __restrict__ src = reinterpret_cast<const float4*>(a.states);
  float4* __restrict__ dst = reinterpret_cast<float4*>(a.prev);
#pragma unroll 4
  for (int c = 0; c < sh.nC; ++c) {
    const long long off = ((static_cast<long long>(b) * sh.nC + c) * a.heads + h) * per + e;
    const float4 cs = src[off];
    const float d = expf(cum[static_cast<long long>(c) * sh.Q]);  // 0 once cum < -104: no NaN
    dst[off] = st;
    st = make_float4(fmaf(st.x, d, cs.x), fmaf(st.y, d, cs.y), fmaf(st.z, d, cs.z),
                     fmaf(st.w, d, cs.w));
  }
  reinterpret_cast<float4*>(a.final_state + bh * pn)[e] = st;
}

// ---------------------------------------------------------------- pass 5
// One block of 4 warps per (kR-row tile, head, chunk, b), the tiles with the
// most key tiles first; warp w owns rows 32w.. of the tile (two 16-row
// fragments, so that each split B fragment serves two products) and all P
// columns of y.  Operands come 64 columns (of N, or of keys) at a time.
constexpr int kLDA = kT + 4;  // C and CB rows, prev rows (= 4 mod 32)
constexpr int kLDX = kP + 8;  // x rows (= 8 mod 32)
constexpr int out_smem_floats() { return kMaxQ + kR * kLDA + kT * kLDX; }

template <typename T, int N>
__global__ void __launch_bounds__(128) ssd_scan_out_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* s_cum = smem;             // cum of rows 0 .. i0 + kR - 1
  float* s_a = smem + kMaxQ;       // C or CB rows i0.. [kR][kLDA]
  float* s_b = s_a + kR * kLDA;    // prev [kP][kLDA], or x rows j0.. [kT][kLDX]
  const Shape sh(a);
  const int n_r = sh.Qp / kR;
  int blk = blockIdx.x;
  const int ti = n_r - 1 - blk % n_r;
  blk /= n_r;
  const int h = blk % a.heads;
  blk /= a.heads;
  const int c = blk % sh.nC, b = blk / sh.nC;
  const int g = h / (a.heads / a.groups);
  const int i0 = ti * kR;
  const long long s0 = static_cast<long long>(c) * sh.Q;
  {
    const float* cum = a.cum + (static_cast<long long>(b * a.heads + h) * sh.nC + c) * sh.Q;
    for (int i = threadIdx.x; i < i0 + kR; i += 128) s_cum[i] = i < sh.Q ? cum[i] : 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int r0 = warp * 32 + gq;  // this thread's rows of the tile: r0 + 16m + {0, 8}
  float acc[2][8][4];
  zero(acc[0]);
  zero(acc[1]);

  // the carried-in state: y_i = exp(cum_i) sum_n C[i, n] prev[p, n]; none
  // in the first chunk without an initial state
  if (a.has_init || c > 0) {
    const T* cp = static_cast<const T*>(a.C) + b * a.c_s[0] + (s0 + i0) * a.c_s[1] + g * a.c_s[2];
    const float* pp = a.prev + (static_cast<long long>(b * sh.nC + c) * a.heads + h) * kP * N;
    for (int n0 = 0; n0 < N; n0 += kT) {
      __syncthreads();  // the previous slice's reads are done
      stage<T, 128>(s_a, kLDA, cp + n0, a.c_s[1], kR, sh.Q - i0, kT, a.vec);
      stage<float, 128>(s_b, kLDA, pp + n0, N, kP, kP, kT, true);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 2
      for (int k0 = 0; k0 < kT; k0 += 8) {
        Frag af[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* ar = s_a + (r0 + 16 * m) * kLDA + k0 + tq;
          af[m].set(ar[0], ar[8 * kLDA], ar[4], ar[8 * kLDA + 4]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* br = s_b + (nt * 8 + gq) * kLDA + k0 + tq;
          const BFrag bf(br[0], br[4]);
          mma3(acc[0][nt], af[0], bf);
          mma3(acc[1][nt], af[1], bf);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = i0 + r0 + 16 * m;
      const float e0 = i < sh.Q ? expf(s_cum[i]) : 0.f;
      const float e1 = i + 8 < sh.Q ? expf(s_cum[i + 8]) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[m][nt][0] *= e0;
        acc[m][nt][1] *= e0;
        acc[m][nt][2] *= e1;
        acc[m][nt][3] *= e1;
      }
    }
  }

  // within the chunk: y_i += sum_{j <= i} CB[i, j] exp(cum_i - cum_j) x_j
  const float* cbp = a.cb + ((static_cast<long long>(b * sh.nC + c) * a.groups + g) * sh.Qp + i0) * sh.Qp;
  const T* xp = static_cast<const T*>(a.x) + b * a.x_s[0] + s0 * a.x_s[1] + h * a.x_s[2];
  const int last = min(i0 + kR, sh.Q) - 1;  // the last row of the tile in the chunk
  for (int j0 = 0; j0 <= last; j0 += kT) {
    __syncthreads();  // the previous tile's reads are done
    stage<float, 128>(s_a, kLDA, cbp + j0, sh.Qp, kR, kR, kT, true);
    stage<T, 128>(s_b, kLDX, xp + j0 * a.x_s[1], a.x_s[1], kT, sh.Q - j0, kP, a.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // k-steps right of every row of a fragment are skipped (warp-uniform)
    const int row_lo = i0 + warp * 32 - j0;  // the warp's first row, from j0
    const int k_end = min(kT, row_lo + 32);
    for (int k0 = 0; k0 < k_end; k0 += 8) {
      const int ja = j0 + k0 + tq, jb = ja + 4;
      const float cja = s_cum[ja], cjb = s_cum[jb];
      const bool first = k0 < row_lo + 16;  // the first fragment has a row at or past k0
      Frag af[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 0 && !first) continue;
        const int ia = i0 + r0 + 16 * m, ib = ia + 8;
        const float ca = s_cum[ia], cb = s_cum[ib];
        const float* ar = s_a + (r0 + 16 * m) * kLDA + k0 + tq;
        // every row of the fragment at or past the k-step's last key and in
        // the chunk: nothing to select (warp-uniform)
        if (j0 + k0 + 7 <= i0 + warp * 32 + 16 * m && i0 + warp * 32 + 16 * m + 15 < sh.Q) {
          af[m].set(ar[0] * expf(ca - cja), ar[8 * kLDA] * expf(cb - cja), ar[4] * expf(ca - cjb),
                    ar[8 * kLDA + 4] * expf(cb - cjb));
        } else {
          af[m].set(ja <= ia && ia < sh.Q ? ar[0] * expf(ca - cja) : 0.f,
                    ja <= ib && ib < sh.Q ? ar[8 * kLDA] * expf(cb - cja) : 0.f,
                    jb <= ia && ia < sh.Q ? ar[4] * expf(ca - cjb) : 0.f,
                    jb <= ib && ib < sh.Q ? ar[8 * kLDA + 4] * expf(cb - cjb) : 0.f);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* br = s_b + (k0 + tq) * kLDX + nt * 8 + gq;
        const BFrag bf(br[0], br[4 * kLDX]);
        if (first) mma3(acc[0][nt], af[0], bf);
        mma3(acc[1][nt], af[1], bf);
      }
    }
  }

  T* yp = static_cast<T*>(a.y) + b * a.y_s[0] + h * a.y_s[2] + 2 * tq;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int ia = i0 + r0 + 16 * m, ib = ia + 8;
    if (ia < sh.Q) {
      T* row = yp + (s0 + ia) * a.y_s[1];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) store2(row + nt * 8, acc[m][nt][0], acc[m][nt][1]);
    }
    if (ib < sh.Q) {
      T* row = yp + (s0 + ib) * a.y_s[1];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) store2(row + nt * 8, acc[m][nt][2], acc[m][nt][3]);
    }
  }
}

template <typename K>
int with_smem(K kernel, size_t floats) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(floats * sizeof(float))));
}

unsigned blocks(long long threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

template <typename T, int N>
int launch(const SsdArgs* a, int passes) {
  const int Q = a->chunk, nC = a->seq / Q, nT = (Q + kT - 1) / kT, nR = (Q + kR - 1) / kR;
  const long long bc = static_cast<long long>(a->batch) * nC;
  int err;
  if (passes & kCum) {
    ssd_scan_cum_kernel<<<static_cast<unsigned>(bc * ((a->heads + 31) / 32)), 256, 0, a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kCb) {
    if ((err = with_smem(ssd_scan_cb_kernel<T, N>, cb_smem_floats<N>()))) return err;
    ssd_scan_cb_kernel<T, N><<<static_cast<unsigned>(bc * a->groups * nT * (nT + 1) / 2), 128,
                               cb_smem_floats<N>() * sizeof(float), a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kStates) {
    if ((err = with_smem(ssd_scan_states_kernel<T, N>, states_smem_floats<N>()))) return err;
    ssd_scan_states_kernel<T, N><<<static_cast<unsigned>(bc * a->heads), 128,
                                   states_smem_floats<N>() * sizeof(float), a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kCarry) {
    const long long threads = static_cast<long long>(a->batch) * a->heads * a->head_dim * N / 4;
    ssd_scan_carry_kernel<<<blocks(threads, 256), 256, 0, a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kOut) {
    if ((err = with_smem(ssd_scan_out_kernel<T, N>, out_smem_floats()))) return err;
    ssd_scan_out_kernel<T, N><<<static_cast<unsigned>(bc * a->heads * nR), 128,
                                out_smem_floats() * sizeof(float), a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  return 0;
}

template <typename T>
int dispatch_state(const SsdArgs* a, int passes) {
  switch (a->d_state) {
    case 64: return launch<T, 64>(a, passes);
    case 128: return launch<T, 128>(a, passes);
    default: return -1;
  }
}

}  // namespace

// Launches the passes named by the bits of `passes` (kCum | ... | kOut for
// the whole scan) on a->stream, in order.  Returns the first nonzero
// cudaGetLastError() after a launch, or -1 for a shape this build has no
// instance for (the wrapper checks that first).
extern "C" int ssd_scan_launch(const SsdArgs* a, int passes) {
  if (a->head_dim != kP || a->chunk > kMaxQ || a->chunk <= 0 || a->seq % a->chunk ||
      a->groups <= 0 || a->heads % a->groups)
    return -1;
  switch (a->dtype) {
    case 0: return dispatch_state<float>(a, passes);
    case 1: return dispatch_state<__nv_bfloat16>(a, passes);
    default: return -1;
  }
}
