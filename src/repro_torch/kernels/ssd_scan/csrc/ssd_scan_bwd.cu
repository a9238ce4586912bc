// Backward of the Mamba2 SSD chunk scan for Hopper (sm_90a), CUDA C++.
//
// The JAX package has no backward kernel for `ssd_scan_fwd`
// (src/repro/kernels/ssd_scan/ssd_scan.py): it differentiates its jnp
// reference `ssd_chunked` (src/repro/models/mamba2.py) by autodiff.  This is
// the port's own backward of the forward in ssd_scan.cu, the vector-Jacobian
// product of y and the final state.  Per (batch, chunk, head), with cum the
// running sum of dA over the chunk, M = C B^T, L[i, j] = exp(cum_i - cum_j)
// for i >= j, S = M o L, e = exp(cum), w = exp(cum_last - cum), prev the
// state entering the chunk and g the gradient of the state leaving it:
//   dprev = (dy o e)^T C + exp(cum_last) g   (= g of the chunk before),
//   dx    = S^T dy + w o (B g^T),
//   dM    = (dy x^T) o L,  dC = dM B + (dy o e) prev,  dB = dM^T C + (x o w) g,
//   dcum  = rowsum(dS o S) - colsum(dS o S) + the e, w and decay terms,
//   d_dA  = the reverse running sum of dcum within the chunk.
//
// What bounds it: operations.  Per (b, chunk, head) it needs four Q x Q
// products on the lower triangle (dy x^T, S^T dy, dM^T C, dM B) and four
// Q x P x N products for the state terms, some 3.5 times the forward's work,
// against a few bytes read per position.  It reads the forward's saved
// scratch (cum, C B^T and prev) instead of recomputing passes 1-4: under
// remat the forward has just been recomputed, so saving costs one group's
// memory and recomputing would cost its time.  Like the forward it is
// parallel over (batch, chunk, head) except for a reverse walk over the
// chunks, in six passes:
//   1. dprev  [B, nC, H, P, N]  (dy o e)^T C per (b, chunk, head);
//   2. dstate [B, nC, H, P, N]  the reverse walk per (b, h) and state entry,
//             seeded with dfinal: dstate_c = g, g = dprev_c + exp(cum_last) g;
//             it writes d_init;
//   3. dx     per (b, chunk, head, 64 keys j): dx, this head's dB, of dcum
//             the column sums -colsum(dS o S) and the w term dw_j, and (the
//             first key tile) the decay term exp(cum_last) <prev, g>;
//   4. dC     per (b, chunk, head, 64 rows i): this head's dC and of dcum the
//             row sums rowsum(dS o S) plus the e term;
//   5. d_dA   one thread per (b, h, chunk) sums dcum's parts and takes the
//             reverse running sum in order: dcum is a difference of row and
//             column sums that can cancel, and a sequential fp32 sum is the
//             plain version's (a tree scan missed the forward's gate);
//   6. fold   dB and dC [B, S, G, N]: each group's heads summed in order.
// dB and dC sum over a group's heads, which passes 3 and 4 keep apart in
// per-head scratch; no pass uses atomics, so results are deterministic.  The
// products of passes 1, 3 and 4 run on the tensor cores in 3xTF32, as the
// forward's do (ssd_mma.cuh): 8 warps own a 64-row tile as 16-row slices of
// half its columns, read their operands from shared memory in rows padded
// to 4 mod 32 floats, and dy x^T, whose error dcum's cancelling sums carry,
// rounds each k-step into its sum.  Row and column sums of dS o S are taken
// from the accumulator fragments by shuffles and folded across warps in a
// fixed order.  exp(cum_i - cum_j) is taken only where i >= j (a select,
// never a multiply by a mask: above the diagonal it overflows to inf, and
// inf * 0 is NaN); C B^T above the diagonal is never computed by the forward
// and is never read into a sum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_mma.cuh"

// Mirrored field for field by ctypes in ops.py.  Strides are in elements, in
// the order (batch, seq, head or group); the last dim is contiguous.  All
// tensors are fp32; every output and scratch tensor is contiguous.  `vec`
// says that x, B, C and dy and their strides are 16-byte aligned, so their
// rows are copied 16 bytes at a time.
struct SsdBwdArgs {
  int batch, seq, heads, groups, head_dim, d_state, chunk, has_dfinal, vec;
  const float* x;       // [B, S, H, P], x_s
  const float* B;       // [B, S, G, N], b_s
  const float* C;       // [B, S, G, N], c_s
  const float* dy;      // [B, S, H, P], dy_s
  const float* cum;     // [B, H, nC, Q]       the forward's pass 1
  const float* cb;      // [B, nC, G, Qp, Qp]  the forward's pass 2
  const float* prev;    // [B, nC, H, P, N]    the forward's pass 4
  const float* dfinal;  // [B, H, P, N] (has_dfinal)
  float* dprev;         // [B, nC, H, P, N]
  float* dstate;        // [B, nC, H, P, N]
  float* dx;            // [B, S, H, P]
  float* dBh;           // [B, S, H, N]
  float* dCh;           // [B, S, H, N]
  float* dcum_row;      // [B, H, nC, Q]
  float* dcum_col;      // [B, H, nC, Q]
  float* dw;            // [B, H, nC, Q]
  float* ddecay;        // [B, H, nC]
  float* d_init;        // [B, H, P, N]
  float* d_dA;          // [B, S, H]
  float* dB;            // [B, S, G, N]
  float* dC;            // [B, S, G, N]
  long long x_s[3], b_s[3], c_s[3], dy_s[3];
  cudaStream_t stream;
};

// The passes, as bits of ssd_scan_bwd_launch's `passes`.
enum { kDprev = 1, kDcarry = 2, kDx = 4, kDc = 8, kDdA = 16, kFold = 32 };

namespace {

constexpr int kT = 64;        // chunk positions per tile
constexpr int kR = 128;       // the forward's output rows a block: C B^T rows are padded to it
constexpr int kP = 64;        // head_dim, the one instance
constexpr int kMaxQ = 512;
constexpr int kThreads = 256;  // 8 warps; warp w owns rows 16 (w % 4).. of a 64-row tile
constexpr int kLD = kT + 4;    // rows of 64 floats in shared memory (= 4 mod 32)

struct Shape {
  int Q, nC, nT, Qp;  // nT 64-row tiles cover the chunk; Qp rounds Q up to kR
  __device__ __forceinline__ explicit Shape(const SsdBwdArgs& a)
      : Q(a.chunk), nC(a.seq / a.chunk), nT((a.chunk + kT - 1) / kT),
        Qp(((a.chunk + kR - 1) / kR) * kR) {}
};

// The tile of a 64 x W product that this thread's warp owns: rows row0 =
// 16 (warp % 4).. and columns col0 = (W / 2) (warp / 4).., as W / 16
// accumulator fragments of 16 x 8 (element e of fragment t: row row0 + gq +
// 8 (e / 2), column col0 + 8 t + 2 tq + e % 2).
struct Tile {
  int row0, col0, gq, tq;
  __device__ __forceinline__ explicit Tile(int W)
      : row0(16 * ((threadIdx.x / 32) % 4)), col0((W / 2) * (threadIdx.x / 128)),
        gq((threadIdx.x % 32) / 4), tq(threadIdx.x % 4) {}
  __device__ __forceinline__ int row(int e) const { return row0 + gq + 8 * (e / 2); }
  __device__ __forceinline__ int col(int t, int e) const { return col0 + 8 * t + 2 * tq + e % 2; }
};

// acc += A B over k < K for the warp's tile of the 64 x (16 NT) output, in
// 3xTF32, with A(i, k) = A[i * a_i + k * a_k] and B(k, j) = Bm[k * b_k + j *
// b_j] in shared memory; `kRound` sums each k-step from zero and rounds it
// into acc (see mma3_rounded), for a product whose error dcum's cancelling
// sums would carry.
template <int NT, bool kRound>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const Tile& t, const float* A,
                                         int a_i, int a_k, const float* Bm, int b_k, int b_j,
                                         int K) {
  const float* a0 = A + (t.row0 + t.gq) * a_i + t.tq * a_k;
  const float* b0 = Bm + t.tq * b_k + (t.col0 + t.gq) * b_j;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float* ar = a0 + k0 * a_k;
    Frag af;
    af.set(ar[0], ar[8 * a_i], ar[4 * a_k], ar[8 * a_i + 4 * a_k]);
    const float* br = b0 + k0 * b_k;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const BFrag bf(br[8 * n * b_j], br[8 * n * b_j + 4 * b_k]);
      if (kRound) {
        mma3_rounded(acc[n], af, bf);
      } else {
        mma3(acc[n], af, bf);
      }
    }
  }
}

// The sum of v over the lanes of a warp that differ in lane bits kLo..kHi
// (xor offsets from the highest); each of them gets the same bits.
template <int kHi, int kLo>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = kHi; o >= kLo; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, rows) x columns [0, cols) of a row-major fp32 source (rows
// `ld_src` elements apart) into dst (rows `ld` floats apart); rows at or
// past `valid` are zero-filled.  With `vec` (source and row stride 16-byte
// aligned) 16 bytes at a time.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, long long ld_src,
                                      int rows, int valid, int cols, bool vec) {
  if (vec) {
    const int per = cols / 4;
    for (int idx = threadIdx.x; idx < rows * per; idx += kThreads) {
      const int r = idx / per, c = (idx % per) * 4;
      *reinterpret_cast<float4*>(dst + r * ld + c) =
          r < valid ? *reinterpret_cast<const float4*>(src + r * ld_src + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
      const int r = idx / cols, c = idx % cols;
      dst[r * ld + c] = r < valid ? src[r * ld_src + c] : 0.f;
    }
  }
}

// ---------------------------------------------------------------- pass 1
// One block per (head, chunk, b): dprev[p, n] = sum_i e_i dy[i, p] C[i, n],
// 64 rows of the chunk a step.
template <int N>
constexpr int dprev_smem_floats() {
  return kT * kLD + kT * (N + 4);
}

template <int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dprev_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDN = N + 4;
  float* s_dy = smem;            // [kT][kLD], rows scaled by e_i
  float* s_c = smem + kT * kLD;  // [kT][LDN]
  const Shape sh(a);
  int blk = blockIdx.x;
  const int h = blk % a.heads;
  blk /= a.heads;
  const int c = blk % sh.nC, b = blk / sh.nC;
  const int g = h / (a.heads / a.groups);
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* dyp = a.dy + b * a.dy_s[0] + s0 * a.dy_s[1] + h * a.dy_s[2];
  const float* cp = a.C + b * a.c_s[0] + s0 * a.c_s[1] + g * a.c_s[2];
  const float* cum = a.cum + (static_cast<long long>(b * a.heads + h) * sh.nC + c) * sh.Q;
  const Tile t(N);
  float acc[N / 16][4];
  zero(acc);
  for (int i0 = 0; i0 < sh.Q; i0 += kT) {
    const int rows = min(kT, sh.Q - i0);
    __syncthreads();  // the previous tile's reads are done
    stage(s_dy, kLD, dyp + i0 * a.dy_s[1], a.dy_s[1], kT, rows, kP, a.vec);
    stage(s_c, LDN, cp + i0 * a.c_s[1], a.c_s[1], kT, rows, N, a.vec);
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * kP; idx += kThreads)
      s_dy[(idx / kP) * kLD + idx % kP] *= expf(cum[i0 + idx / kP]);
    __syncthreads();
    warp_mma<N / 16, false>(acc, t, s_dy, 1, kLD, s_c, LDN, 1, kT);  // (dy o e)^T C
  }
  float* out = a.dprev + ((static_cast<long long>(b) * sh.nC + c) * a.heads + h) * kP * N;
#pragma unroll
  for (int n = 0; n < N / 16; ++n) {
    *reinterpret_cast<float2*>(out + t.row(0) * N + t.col(n, 0)) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + t.row(2) * N + t.col(n, 0)) = make_float2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------- pass 2
// One thread per (b, h, state entry), walking the chunks in reverse.
__global__ void __launch_bounds__(kThreads) ssd_bwd_carry_kernel(const SsdBwdArgs a) {
  const Shape sh(a);
  const long long pn = static_cast<long long>(a.head_dim) * a.d_state;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(a.batch) * a.heads * pn) return;
  const long long e = t % pn, bh = t / pn;  // bh = b * H + h
  const int h = static_cast<int>(bh % a.heads), b = static_cast<int>(bh / a.heads);
  float g = a.has_dfinal ? a.dfinal[bh * pn + e] : 0.f;
  const float* cum = a.cum + bh * sh.nC * sh.Q + sh.Q - 1;
  for (int c = sh.nC - 1; c >= 0; --c) {
    const long long off = ((static_cast<long long>(b) * sh.nC + c) * a.heads + h) * pn + e;
    const float part = a.dprev[off];
    a.dstate[off] = g;
    g = fmaf(expf(cum[static_cast<long long>(c) * sh.Q]), g, part);
  }
  a.d_init[bh * pn + e] = g;
}

// ---------------------------------------------------------------- passes 3, 4
// The warp's part of the tile of dS = dy_I x_J^T for rows I0.. and keys J0..
// of a chunk, in place in `dS`, and its masked forms written to shared
// memory: s_S = C B^T o L (read from s_S, which holds the tile of C B^T, in
// place; when `with_s`) and s_dM = dS o L; dS itself becomes T = dS o S.
// Each is 0 where i < j or past the chunk.
__device__ __forceinline__ void intra_tile(float (&dS)[4][4], const Tile& t, float* s_S,
                                           float* s_dM, const float* s_dy, const float* s_x,
                                           const float* s_cum_i, const float* s_cum_j, int I0,
                                           int J0, int Q, bool with_s) {
  zero(dS);
  warp_mma<4, true>(dS, t, s_dy, kLD, 1, s_x, 1, kLD, kP);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = t.row(e), j = t.col(n, e);
      const bool ok = I0 + i >= J0 + j && I0 + i < Q;
      const float L = ok ? expf(s_cum_i[i] - s_cum_j[j]) : 0.f;
      const float S = ok ? s_S[i * kLD + j] * L : 0.f;
      if (with_s) s_S[i * kLD + j] = S;
      s_dM[i * kLD + j] = ok ? dS[n][e] * L : 0.f;
      dS[n][e] = ok ? dS[n][e] * S : 0.f;
    }
  }
}

template <int N>
constexpr int dx_smem_floats() {
  // x_J, dy_I, C B^T / S, dM, B_J, C_I (dstate after the loop, over dy_I and
  // on), cum_J, cum_I, w, the column sums' 4 x 64 partials
  return 4 * kT * kLD + 2 * kT * (N + 4) + 3 * kT + 4 * kT;
}

// One block per (key tile J, head, chunk, b), the tiles with the most row
// tiles first; walks the row tiles I >= J.
template <int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dx_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDN = N + 4, NB = N / 16;
  const Shape sh(a);
  int blk = blockIdx.x;
  const int jt = blk % sh.nT;
  blk /= sh.nT;
  const int h = blk % a.heads;
  blk /= a.heads;
  const int c = blk % sh.nC, b = blk / sh.nC;
  const int g = h / (a.heads / a.groups);
  float* s_x = smem;                  // [kT][kLD]
  float* s_S = s_x + kT * kLD;        // [kT][kLD]: C B^T, then S
  float* s_dM = s_S + kT * kLD;       // [kT][kLD]
  float* s_b = s_dM + kT * kLD;       // [kT][LDN]
  float* s_dy = s_b + kT * LDN;       // [kT][kLD]
  float* s_c = s_dy + kT * kLD;       // [kT][LDN]
  float* s_cum_j = s_c + kT * LDN;    // [kT]
  float* s_cum_i = s_cum_j + kT;
  float* s_w = s_cum_i + kT;
  float* s_red = s_w + kT;            // [4][kT]
  float* s_ds = s_dy;                 // [kP][LDN] after the loop, over s_dy and s_c

  const int J0 = jt * kT, rows_j = min(kT, sh.Q - J0);
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* xp = a.x + b * a.x_s[0] + s0 * a.x_s[1] + h * a.x_s[2];
  const float* dyp = a.dy + b * a.dy_s[0] + s0 * a.dy_s[1] + h * a.dy_s[2];
  const float* bp = a.B + b * a.b_s[0] + s0 * a.b_s[1] + g * a.b_s[2];
  const float* cp = a.C + b * a.c_s[0] + s0 * a.c_s[1] + g * a.c_s[2];
  const long long bhc = (static_cast<long long>(b * a.heads + h) * sh.nC + c) * sh.Q;
  const float* cum = a.cum + bhc;
  const float* cbp = a.cb + (static_cast<long long>(b * sh.nC + c) * a.groups + g) * sh.Qp * sh.Qp;
  const float cum_last = cum[sh.Q - 1];

  stage(s_x, kLD, xp + J0 * a.x_s[1], a.x_s[1], kT, rows_j, kP, a.vec);
  stage(s_b, LDN, bp + J0 * a.b_s[1], a.b_s[1], kT, rows_j, N, a.vec);
  for (int j = threadIdx.x; j < kT; j += kThreads) {
    s_cum_j[j] = j < rows_j ? cum[J0 + j] : 0.f;
    s_w[j] = j < rows_j ? expf(cum_last - cum[J0 + j]) : 0.f;
  }
  const Tile t64(kT), tN(N);
  float acc_dx[4][4], acc_db[NB][4];
  zero(acc_dx);
  zero(acc_db);
  float col = 0.f;  // -colsum(dS o S) of key J0 + threadIdx.x (threads < kT)
  for (int it = jt; it < sh.nT; ++it) {
    const int I0 = it * kT, rows_i = min(kT, sh.Q - I0);
    __syncthreads();  // the previous tile's reads are done
    stage(s_dy, kLD, dyp + I0 * a.dy_s[1], a.dy_s[1], kT, rows_i, kP, a.vec);
    stage(s_c, LDN, cp + I0 * a.c_s[1], a.c_s[1], kT, rows_i, N, a.vec);
    stage(s_S, kLD, cbp + static_cast<long long>(I0) * sh.Qp + J0, sh.Qp, kT, kT, kT, true);
    for (int i = threadIdx.x; i < kT; i += kThreads) s_cum_i[i] = i < rows_i ? cum[I0 + i] : 0.f;
    __syncthreads();
    float T[4][4];
    intra_tile(T, t64, s_S, s_dM, s_dy, s_x, s_cum_i, s_cum_j, I0, J0, sh.Q, true);
    // column sums of T: over the warp's 16 rows, then its 4 row warps in order
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = lane_sum<16, 4>(T[n][e] + T[n][e + 2]);
        if (t64.gq == 0) s_red[(t64.row0 / 16) * kT + t64.col(n, e)] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < kT)
      for (int w = 0; w < 4; ++w) col -= s_red[w * kT + threadIdx.x];
    warp_mma<4, false>(acc_dx, t64, s_S, 1, kLD, s_dy, kLD, 1, kT);   // S^T dy
    warp_mma<NB, false>(acc_db, tN, s_dM, 1, kLD, s_c, LDN, 1, kT);   // dM^T C
  }
  __syncthreads();
  // the state terms, with g = dstate of this chunk in shared memory
  const long long st = ((static_cast<long long>(b) * sh.nC + c) * a.heads + h) * kP * N;
  stage(s_ds, LDN, a.dstate + st, N, kP, kP, N, true);
  __syncthreads();
  {
    float bg[4][4];  // (B g^T)[j, p]
    zero(bg);
    warp_mma<4, false>(bg, t64, s_b, LDN, 1, s_ds, 1, LDN, N);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dx[n][e] = fmaf(s_w[t64.row(e)], bg[n][e], acc_dx[n][e]);
  }
  float xg[NB][4];  // (x g)[j, n]
  zero(xg);
  warp_mma<NB, false>(xg, tN, s_x, kLD, 1, s_ds, LDN, 1, kP);
  float dwp[2] = {0.f, 0.f};  // sum_n B[j, n] (w_j (x g)[j, n]) over this thread's columns
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = tN.row(e);
      const float v = s_w[j] * xg[n][e];
      acc_db[n][e] += v;
      dwp[e / 2] = fmaf(s_b[j * LDN + tN.col(n, e)], v, dwp[e / 2]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float v = lane_sum<2, 1>(dwp[r]);  // over the warp's columns, then its 2 column warps
    if (tN.tq == 0) s_red[(tN.col0 ? kT : 0) + tN.row(2 * r)] = v;
  }

  const long long row0 = (static_cast<long long>(b) * a.seq + s0 + J0) * a.heads + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = t64.row(2 * r);
    if (j >= rows_j) continue;
    float* dxr = a.dx + (row0 + static_cast<long long>(j) * a.heads) * kP;
#pragma unroll
    for (int n = 0; n < 4; ++n)
      *reinterpret_cast<float2*>(dxr + t64.col(n, 0)) =
          make_float2(acc_dx[n][2 * r], acc_dx[n][2 * r + 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = tN.row(2 * r);
    if (j >= rows_j) continue;
    float* dbr = a.dBh + (row0 + static_cast<long long>(j) * a.heads) * N;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(dbr + tN.col(n, 0)) =
          make_float2(acc_db[n][2 * r], acc_db[n][2 * r + 1]);
  }
  __syncthreads();
  if (threadIdx.x < rows_j) {
    a.dcum_col[bhc + J0 + threadIdx.x] = col;
    a.dw[bhc + J0 + threadIdx.x] = s_red[threadIdx.x] + s_red[kT + threadIdx.x];
  }

  if (jt == 0) {
    // exp(cum_last) <prev, g>: per-thread sums, then the warps' sums in order
    const float* pv = a.prev + st;
    float part = 0.f;
    for (int e = threadIdx.x; e < kP * N; e += kThreads)
      part = fmaf(pv[e], s_ds[(e / N) * LDN + e % N], part);
    part = lane_sum<16, 1>(part);
    __syncthreads();  // every read of s_red is done
    if (threadIdx.x % 32 == 0) s_red[threadIdx.x / 32] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) sum += s_red[w];
      a.ddecay[(static_cast<long long>(b * a.heads + h)) * sh.nC + c] = expf(cum_last) * sum;
    }
  }
}

template <int N>
constexpr int dc_smem_floats() {
  // dy_I, x_J, C B^T / dM, B_J, C_I (prev after the loop, over x_J and on),
  // cum_I, cum_J, the row sums' 2 x 64 partials
  return 3 * kT * kLD + 2 * kT * (N + 4) + 2 * kT + 2 * kT;
}

// One block per (row tile I, head, chunk, b), the tiles with the most key
// tiles first; walks the key tiles J <= I.
template <int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dc_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDN = N + 4, NB = N / 16;
  const Shape sh(a);
  int blk = blockIdx.x;
  const int it = sh.nT - 1 - blk % sh.nT;
  blk /= sh.nT;
  const int h = blk % a.heads;
  blk /= a.heads;
  const int c = blk % sh.nC, b = blk / sh.nC;
  const int g = h / (a.heads / a.groups);
  float* s_dy = smem;                 // [kT][kLD]
  float* s_M = s_dy + kT * kLD;       // [kT][kLD]: C B^T, then dM
  float* s_c = s_M + kT * kLD;        // [kT][LDN], staged after the loop
  float* s_x = s_c + kT * LDN;        // [kT][kLD]
  float* s_b = s_x + kT * kLD;        // [kT][LDN]
  float* s_cum_i = s_b + kT * LDN;    // [kT]
  float* s_cum_j = s_cum_i + kT;
  float* s_red = s_cum_j + kT;        // [2][kT]
  float* s_prev = s_x;                // [kP][LDN] after the loop, over s_x and s_b

  const int I0 = it * kT, rows_i = min(kT, sh.Q - I0);
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* xp = a.x + b * a.x_s[0] + s0 * a.x_s[1] + h * a.x_s[2];
  const float* dyp = a.dy + b * a.dy_s[0] + s0 * a.dy_s[1] + h * a.dy_s[2];
  const float* bp = a.B + b * a.b_s[0] + s0 * a.b_s[1] + g * a.b_s[2];
  const float* cp = a.C + b * a.c_s[0] + s0 * a.c_s[1] + g * a.c_s[2];
  const long long bhc = (static_cast<long long>(b * a.heads + h) * sh.nC + c) * sh.Q;
  const float* cum = a.cum + bhc;
  const float* cbp = a.cb + (static_cast<long long>(b * sh.nC + c) * a.groups + g) * sh.Qp * sh.Qp;

  stage(s_dy, kLD, dyp + I0 * a.dy_s[1], a.dy_s[1], kT, rows_i, kP, a.vec);
  for (int i = threadIdx.x; i < kT; i += kThreads) s_cum_i[i] = i < rows_i ? cum[I0 + i] : 0.f;
  const Tile t64(kT), tN(N);
  float acc[NB][4];
  zero(acc);
  float row = 0.f;  // rowsum(dS o S) of row I0 + threadIdx.x (threads < kT)
  for (int jt = 0; jt <= it; ++jt) {
    const int J0 = jt * kT, rows_j = min(kT, sh.Q - J0);
    __syncthreads();  // the previous tile's reads are done
    stage(s_x, kLD, xp + J0 * a.x_s[1], a.x_s[1], kT, rows_j, kP, a.vec);
    stage(s_b, LDN, bp + J0 * a.b_s[1], a.b_s[1], kT, rows_j, N, a.vec);
    stage(s_M, kLD, cbp + static_cast<long long>(I0) * sh.Qp + J0, sh.Qp, kT, kT, kT, true);
    for (int j = threadIdx.x; j < kT; j += kThreads) s_cum_j[j] = j < rows_j ? cum[J0 + j] : 0.f;
    __syncthreads();
    // s_M holds C B^T: each thread reads its entries before it writes dM over them
    float T[4][4];
    intra_tile(T, t64, s_M, s_M, s_dy, s_x, s_cum_i, s_cum_j, I0, J0, sh.Q, false);
    // row sums of T: over the warp's 32 columns, then its 2 column warps in order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) v += T[n][2 * r] + T[n][2 * r + 1];
      v = lane_sum<2, 1>(v);
      if (t64.tq == 0) s_red[(t64.col0 ? kT : 0) + t64.row(2 * r)] = v;
    }
    __syncthreads();
    if (threadIdx.x < kT) row += s_red[threadIdx.x] + s_red[kT + threadIdx.x];
    warp_mma<NB, false>(acc, tN, s_M, kLD, 1, s_b, LDN, 1, kT);  // dM B
  }
  __syncthreads();
  // the state term: (dy o e) prev, with prev of this chunk in shared memory
  const long long st = ((static_cast<long long>(b) * sh.nC + c) * a.heads + h) * kP * N;
  stage(s_prev, LDN, a.prev + st, N, kP, kP, N, true);
  stage(s_c, LDN, cp + I0 * a.c_s[1], a.c_s[1], kT, rows_i, N, a.vec);
  __syncthreads();
  float dp[NB][4];
  zero(dp);
  warp_mma<NB, false>(dp, tN, s_dy, kLD, 1, s_prev, LDN, 1, kP);
  float ep[2] = {0.f, 0.f};  // sum_n C[i, n] (e_i (dy prev)[i, n]) over this thread's columns
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = tN.row(e);
      const float v = (i < rows_i ? expf(s_cum_i[i]) : 0.f) * dp[n][e];
      acc[n][e] += v;
      ep[e / 2] = fmaf(s_c[i * LDN + tN.col(n, e)], v, ep[e / 2]);
    }
  }
  __syncthreads();  // every read of s_red is done
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float v = lane_sum<2, 1>(ep[r]);
    if (tN.tq == 0) s_red[(tN.col0 ? kT : 0) + tN.row(2 * r)] = v;
  }

  const long long row0 = (static_cast<long long>(b) * a.seq + s0 + I0) * a.heads + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = tN.row(2 * r);
    if (i >= rows_i) continue;
    float* dcr = a.dCh + (row0 + static_cast<long long>(i) * a.heads) * N;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(dcr + tN.col(n, 0)) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
  __syncthreads();
  if (threadIdx.x < rows_i)
    a.dcum_row[bhc + I0 + threadIdx.x] = row + (s_red[threadIdx.x] + s_red[kT + threadIdx.x]);
}

// ---------------------------------------------------------------- pass 5
// One thread per (b, h, chunk): dcum from its parts, then its reverse
// running sum, in order.
__global__ void __launch_bounds__(kThreads) ssd_bwd_dA_kernel(const SsdBwdArgs a) {
  const Shape sh(a);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(a.batch) * a.heads * sh.nC) return;
  const int c = static_cast<int>(t % sh.nC);
  const long long bh = t / sh.nC;
  const int h = static_cast<int>(bh % a.heads), b = static_cast<int>(bh / a.heads);
  const long long base = t * sh.Q;
  float sw = 0.f;
  for (int i = 0; i < sh.Q; ++i) sw += a.dw[base + i];
  float run = 0.f;
  float* out = a.d_dA + (static_cast<long long>(b) * a.seq + static_cast<long long>(c) * sh.Q) * a.heads + h;
  for (int i = sh.Q - 1; i >= 0; --i) {
    float d = a.dcum_row[base + i] + a.dcum_col[base + i] - a.dw[base + i];
    if (i == sh.Q - 1) d += sw + a.ddecay[t];
    run += d;
    out[static_cast<long long>(i) * a.heads] = run;
  }
}

// ---------------------------------------------------------------- pass 6
// One thread per (b, s, g, n) entry of dB and of dC.
__global__ void __launch_bounds__(kThreads) ssd_bwd_fold_kernel(const SsdBwdArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long total = static_cast<long long>(a.batch) * a.seq * a.groups * a.d_state;
  if (t >= total) return;
  const int n = static_cast<int>(t % a.d_state);
  const long long bsg = t / a.d_state;
  const int g = static_cast<int>(bsg % a.groups);
  const long long bs = bsg / a.groups;
  const int rep = a.heads / a.groups;
  const long long src = (bs * a.heads + static_cast<long long>(g) * rep) * a.d_state + n;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < rep; ++k) {
    sb += a.dBh[src + static_cast<long long>(k) * a.d_state];
    sc += a.dCh[src + static_cast<long long>(k) * a.d_state];
  }
  a.dB[t] = sb;
  a.dC[t] = sc;
}

template <typename K>
int with_smem(K kernel, size_t floats) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(floats * sizeof(float))));
}

unsigned blocks(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <int N>
int launch(const SsdBwdArgs* a, int passes) {
  const int Q = a->chunk, nC = a->seq / Q, nT = (Q + kT - 1) / kT;
  const long long bch = static_cast<long long>(a->batch) * nC * a->heads;
  int err;
  if (passes & kDprev) {
    if ((err = with_smem(ssd_bwd_dprev_kernel<N>, dprev_smem_floats<N>()))) return err;
    ssd_bwd_dprev_kernel<N><<<static_cast<unsigned>(bch), kThreads,
                              dprev_smem_floats<N>() * sizeof(float), a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kDcarry) {
    ssd_bwd_carry_kernel<<<blocks(static_cast<long long>(a->batch) * a->heads * kP * N), kThreads,
                           0, a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kDx) {
    if ((err = with_smem(ssd_bwd_dx_kernel<N>, dx_smem_floats<N>()))) return err;
    ssd_bwd_dx_kernel<N><<<static_cast<unsigned>(bch * nT), kThreads,
                           dx_smem_floats<N>() * sizeof(float), a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kDc) {
    if ((err = with_smem(ssd_bwd_dc_kernel<N>, dc_smem_floats<N>()))) return err;
    ssd_bwd_dc_kernel<N><<<static_cast<unsigned>(bch * nT), kThreads,
                           dc_smem_floats<N>() * sizeof(float), a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kDdA) {
    ssd_bwd_dA_kernel<<<blocks(static_cast<long long>(a->batch) * a->heads * nC), kThreads, 0,
                        a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kFold) {
    ssd_bwd_fold_kernel<<<blocks(static_cast<long long>(a->batch) * a->seq * a->groups * N),
                          kThreads, 0, a->stream>>>(*a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  return 0;
}

}  // namespace

// Launches the passes named by the bits of `passes` (kDprev | ... | kFold for
// the whole backward) on a->stream, in order.  Returns the first nonzero
// cudaGetLastError() after a launch, or -1 for a shape this build has no
// instance for (the wrapper checks that first).
extern "C" int ssd_scan_bwd_launch(const SsdBwdArgs* a, int passes) {
  if (a->head_dim != kP || a->chunk > kMaxQ || a->chunk <= 0 || a->seq % a->chunk ||
      a->groups <= 0 || a->heads % a->groups)
    return -1;
  switch (a->d_state) {
    case 64: return launch<64>(a, passes);
    case 128: return launch<128>(a, passes);
    default: return -1;
  }
}
