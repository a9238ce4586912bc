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
// per-head scratch; no pass uses atomics and every sum is folded in a fixed
// order, so two calls are equal bit for bit.  exp(cum_i - cum_j) is taken
// only where i >= j (a select, never a multiply by a mask: above the
// diagonal it overflows to inf, and inf * 0 is NaN); C B^T above the
// diagonal is never computed by the forward and is never read into a sum.
//
// The tensor passes (1, 3, 4), as designed for Hopper:
//   * Products in 3xTF32 on mma.sync m16n8k8, as the forward's (ssd_mma.cuh):
//     8 warps own a 64-row product as 16-row slices of half its columns and
//     read their operands from shared memory in rows padded to 4 mod 32
//     floats; dy x^T, whose error dcum's cancelling sums carry, rounds each
//     k-step into its sum.  Row and column sums of dS o S are taken from the
//     accumulator fragments by shuffles and folded across warps in order.
//   * A ring of kStages = 2 stages in shared memory, filled by cp.async (16
//     bytes, .cg, where x, B, C and dy and their strides are 16-byte aligned;
//     else 4 bytes, .ca: the unaligned rows take the same pipeline), with
//     zero fill past the chunk.  Stage k + 1 is issued as soon as stage k has
//     landed and every warp is past stage k - 1, and lands while stage k is
//     multiplied.  dx streams 32 rows a stage (the C B^T tile, dy_I, C_I,
//     cum_I), dC 32 keys (the C B^T tile, x_J, B_J, cum_J), dprev 64 rows
//     (dy, C, cum).  B_J and dstate (dx), prev and C_I (dC) are staged after
//     the walk, over the ring.
//   * 16 warps of tensor work on an SM as 2 blocks of 8 warps: each block
//     fits in half the SM's 228 KB, and __launch_bounds__(256, 2) holds a
//     thread to 128 registers.  Shared memory a block, in floats (x 4 bytes),
//     with S = 32 positions a stage, T = 64, P = 64, rows padded by 4:
//       dprev  2 (T (P + 4) + T (N + 4) + T)
//              N 64: 17,536 (70,144 B); N 128: 25,728 (102,912 B)
//       dx     x_J T (P + 4), dM S (P + 4), ring 2 (2 S (T + 4) + S (N + 4)
//              + S), cum_J, w and folds 6 T
//              N 64: 20,032 (80,128 B); N 128: 24,128 (96,512 B)
//       dC     dy_I T (P + 4), ring 2 (T (S + 4) + S (P + 4) + S (N + 4) +
//              S), cum_I and folds 3 T
//              N 64: 17,920 (71,680 B); N 128: 22,016 (88,064 B)
//     ops.py mirrors these sums (`bwd_smem_bytes`) and the card test holds
//     them to ssd_scan_bwd_smem_bytes below.  ptxas (-Xptxas -v, in the build
//     log): 0 bytes spilled in every kernel, at most 128 registers a thread
//     (dx's dM^T C at N 128 unrolls one k-step, where two spilled 48 bytes);
//     chip_smoke.py fails a build that spills.
//   * The TF32 split stays in the fragment loads, as in the forward.  Split
//     once as tiles land ({hi, lo} pairs, one 64-bit load a fragment element)
//     was built and measured on the card, with one 16-warp block an SM and
//     with two 8-warp blocks, and lost to this design at both shapes: a
//     split element is 8 bytes of shared memory to read where a raw one is 4,
//     and split tiles take twice the space, so fewer and smaller stages fit;
//     those passes ran at the shared-memory rate (PERF.md).
//   * mma.sync rather than wgmma: wgmma reads tf32 only K-major from shared
//     memory, so S^T dy, dM^T C and dM B would need transposed copies of
//     dy_I, C_I and B_J; it accumulates inside the tensor core, so dy x^T
//     could not round a k-step into its sum; and it has no CPU rehearsal.
//   * dy x^T and L are computed in both dx and dC: dx walks the row tiles of
//     a key tile and dC the key tiles of a row tile, so neither can sum the
//     other's outputs without atomics.  Handing dM from dx to dC would write
//     and read 4 bytes a lower-triangle entry, 2 x 335 MB at mamba2's
//     training shape ([4,4096,32,64], chunk 256: 2048 (b, chunk, head) x 10
//     tile pairs x 16 KB), 0.20 ms at 3.35 TB/s and 335 MB of scratch,
//     against 0.065 ms for the recompute (2048 x 10 x 2 x 64^3 flops x 3 at
//     the 495 TF/s TF32 peak).

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
constexpr int kStages = 2;     // the ring of walked tiles
constexpr int kS = 32;         // positions a ring stage holds
constexpr int kLDS = kS + 4;   // rows of 32 floats in shared memory (= 4 mod 32)

struct Shape {
  int Q, nC, nT, Qp;  // nT 64-row tiles cover the chunk; Qp rounds Q up to kR
  __device__ __forceinline__ explicit Shape(const SsdBwdArgs& a)
      : Q(a.chunk), nC(a.seq / a.chunk), nT((a.chunk + kT - 1) / kT),
        Qp(((a.chunk + kR - 1) / kR) * kR) {}
};

// The tile of a 64 x W product that this thread's warp owns: rows row0 =
// 16 (warp % 4).. and columns col0 = (W / 2) (warp / 4).., as W / 16
// accumulator fragments of 16 x 8 (element e of fragment t: row row0 + gq +
// 8 (e / 2), column col0 + 8 t + 2 tq + e % 2); or the tile at (r0, c0).
struct Tile {
  int row0, col0, gq, tq;
  __device__ __forceinline__ explicit Tile(int W)
      : row0(16 * ((threadIdx.x / 32) % 4)), col0((W / 2) * (threadIdx.x / 128)),
        gq((threadIdx.x % 32) / 4), tq(threadIdx.x % 4) {}
  __device__ __forceinline__ Tile(int r0, int c0)
      : row0(r0), col0(c0), gq((threadIdx.x % 32) / 4), tq(threadIdx.x % 4) {}
  __device__ __forceinline__ int row(int e) const { return row0 + gq + 8 * (e / 2); }
  __device__ __forceinline__ int col(int t, int e) const { return col0 + 8 * t + 2 * tq + e % 2; }
};

// acc += A B over k < K for the warp's tile of the 64 x (16 NT) output, in
// 3xTF32, with A(i, k) = A[i * a_i + k * a_k] and B(k, j) = Bm[k * b_k + j *
// b_j] in shared memory; `kRound` sums each k-step from zero and rounds it
// into acc (see mma3_rounded), for a product whose error dcum's cancelling
// sums would carry; `kUnroll` k-steps are unrolled.
template <int NT, bool kRound, int kUnroll = 2>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const Tile& t, const float* A,
                                         int a_i, int a_k, const float* Bm, int b_k, int b_j,
                                         int K) {
  const float* a0 = A + (t.row0 + t.gq) * a_i + t.tq * a_k;
  const float* b0 = Bm + t.tq * b_k + (t.col0 + t.gq) * b_j;
#pragma unroll kUnroll
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared memory, asynchronously; zeros when !ok
// (the source is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies but the newest N groups have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copy of rows [0, rows) x columns [0, cols) of a row-major fp32
// source (rows `ld_src` elements apart) into dst (rows `ld` floats apart);
// rows at or past `valid` are zero-filled.  With `vec` (source and row
// stride 16-byte aligned) 16 bytes a copy, else 4.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, long long ld_src,
                                      int rows, int valid, int cols, bool vec) {
  if (vec) {
    const int per = cols / 4;
    for (int idx = threadIdx.x; idx < rows * per; idx += kThreads) {
      const int r = idx / per, c = (idx % per) * 4;
      const bool ok = r < valid;
      cp_async16(dst + r * ld + c, ok ? src + r * ld_src + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
      const int r = idx / cols, c = idx % cols;
      const bool ok = r < valid;
      cp_async4(dst + r * ld + c, ok ? src + r * ld_src + c : src, ok);
    }
  }
}

// Issues the copy of cum[0, n) (zeros at or past `valid`).
__device__ __forceinline__ void stage_cum(float* dst, const float* cum, int n, int valid) {
  for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, i < valid ? cum + i : cum, i < valid);
}

// Lands every copy this thread issued, then the block's.
__device__ __forceinline__ void land() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------- pass 1
// One block per (head, chunk, b): dprev[p, n] = sum_i e_i dy[i, p] C[i, n],
// 64 rows of the chunk a ring stage.
template <int N>
__host__ __device__ constexpr int dprev_stage_floats() {  // dy_i, C_i, cum_i
  return kT * kLD + kT * (N + 4) + kT;
}

template <int N>
__host__ __device__ constexpr int dprev_smem_floats() {
  return kStages * dprev_stage_floats<N>();
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dprev_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDN = N + 4;
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
  // stage k: rows 64 k.. in ring slot k % kStages: dy [kT][kLD], C [kT][LDN], cum
  auto issue = [&](int k) {
    if (k < sh.nT) {
      float* s_dy = smem + (k % kStages) * dprev_stage_floats<N>();
      const int i0 = k * kT, rows = min(kT, sh.Q - i0);
      stage(s_dy, kLD, dyp + i0 * a.dy_s[1], a.dy_s[1], kT, rows, kP, a.vec);
      stage(s_dy + kT * kLD, LDN, cp + i0 * a.c_s[1], a.c_s[1], kT, rows, N, a.vec);
      stage_cum(s_dy + kT * kLD + kT * LDN, cum + i0, kT, rows);
    }
    cp_async_commit();
  };
  const Tile t(N);
  float acc[N / 16][4];
  zero(acc);
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < sh.nT; ++k) {
    float* s_dy = smem + (k % kStages) * dprev_stage_floats<N>();  // rows scaled by e_i
    const float* s_c = s_dy + kT * kLD;
    const float* s_cum = s_c + kT * LDN;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage k has landed; the stage it replaces is read
    issue(k + kStages - 1);
    for (int idx = threadIdx.x; idx < kT * kP; idx += kThreads)
      s_dy[(idx / kP) * kLD + idx % kP] *= expf(s_cum[idx / kP]);
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
// of a chunk (rows of s_dy, keys of s_x, both [.][kLD]), in place in `dS`,
// and its masked forms written to shared memory (rows `ld` floats apart):
// s_S = C B^T o L (read from s_S, which holds the tile of C B^T, in place;
// when `with_s`) and s_dM = dS o L; dS itself becomes T = dS o S.  Each is 0
// where i < j or past the chunk.
template <int NT>
__device__ __forceinline__ void intra_tile(float (&dS)[NT][4], const Tile& t, float* s_S,
                                           float* s_dM, int ld, const float* s_dy,
                                           const float* s_x, const float* s_cum_i,
                                           const float* s_cum_j, int I0, int J0, int Q,
                                           bool with_s) {
  zero(dS);
  warp_mma<NT, true>(dS, t, s_dy, kLD, 1, s_x, 1, kLD, kP);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = t.row(e), j = t.col(n, e);
      const bool ok = I0 + i >= J0 + j && I0 + i < Q;
      const float L = ok ? expf(s_cum_i[i] - s_cum_j[j]) : 0.f;
      const float S = ok ? s_S[i * ld + j] * L : 0.f;
      if (with_s) s_S[i * ld + j] = S;
      s_dM[i * ld + j] = ok ? dS[n][e] * L : 0.f;
      dS[n][e] = ok ? dS[n][e] * S : 0.f;
    }
  }
}

template <int N>
__host__ __device__ constexpr int dx_stage_floats() {  // C B^T / S, dy_I, C_I, cum_I
  return 2 * kS * kLD + kS * (N + 4) + kS;
}

template <int N>
__host__ __device__ constexpr int dx_smem_floats() {
  // x_J, dM, the ring (B_J and dstate after the walk), cum_J, w, the column
  // sums' 4 x 64 partials
  return kT * kLD + kS * kLD + kStages * dx_stage_floats<N>() + 2 * kT + 4 * kT;
}

// One block per (key tile J, head, chunk, b), the tiles with the most row
// tiles first; walks the rows I >= J0, kS a ring stage.
template <int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dx_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDN = N + 4, NB = N / 16, N64 = kT / 16;
  static_assert(2 * kT * LDN <= kStages * dx_stage_floats<N>(), "B_J and dstate fit the ring");
  const Shape sh(a);
  int blk = blockIdx.x;
  const int jt = blk % sh.nT;
  blk /= sh.nT;
  const int h = blk % a.heads;
  blk /= a.heads;
  const int c = blk % sh.nC, b = blk / sh.nC;
  const int g = h / (a.heads / a.groups);
  float* s_x = smem;                  // [kT][kLD]
  float* s_dM = s_x + kT * kLD;       // [kS][kLD]
  float* ring = s_dM + kS * kLD;      // kStages x (s_S, s_dy, s_c, s_cum_i)
  float* s_cum_j = ring + kStages * dx_stage_floats<N>();  // [kT]
  float* s_w = s_cum_j + kT;
  float* s_red = s_w + kT;            // [4][kT]
  float* s_b = ring;                  // [kT][LDN] after the walk
  float* s_ds = ring + kT * LDN;      // [kP][LDN] after the walk

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
  const int n_steps = (sh.Q - J0 + kS - 1) / kS;
  // stage k: rows I0 = J0 + kS k.. in ring slot k % kStages
  auto issue = [&](int k) {
    if (k < n_steps) {
      float* slot = ring + (k % kStages) * dx_stage_floats<N>();
      const int I0 = J0 + k * kS, rows_i = min(kS, sh.Q - I0);
      stage(slot, kLD, cbp + static_cast<long long>(I0) * sh.Qp + J0, sh.Qp, kS, kS, kT, true);
      stage(slot + kS * kLD, kLD, dyp + I0 * a.dy_s[1], a.dy_s[1], kS, rows_i, kP, a.vec);
      stage(slot + 2 * kS * kLD, LDN, cp + I0 * a.c_s[1], a.c_s[1], kS, rows_i, N, a.vec);
      stage_cum(slot + 2 * kS * kLD + kS * LDN, cum + I0, kS, rows_i);
    }
    cp_async_commit();
  };

  stage(s_x, kLD, xp + J0 * a.x_s[1], a.x_s[1], kT, rows_j, kP, a.vec);
  for (int k = 0; k < kStages - 1; ++k) issue(k);  // the first with x_J
  for (int j = threadIdx.x; j < kT; j += kThreads) {
    s_cum_j[j] = j < rows_j ? cum[J0 + j] : 0.f;
    s_w[j] = j < rows_j ? expf(cum_last - cum[J0 + j]) : 0.f;
  }
  // dy x^T's kS x 64 tile: warp w owns rows 16 (w % 2).. and keys 16 (w / 2)..
  const Tile tS(16 * ((threadIdx.x / 32) % 2), 16 * (threadIdx.x / 64)), t64(kT), tN(N);
  float acc_dx[N64][4], acc_db[NB][4];
  zero(acc_dx);
  zero(acc_db);
  float col = 0.f;  // -colsum(dS o S) of key J0 + threadIdx.x (threads < kT)
  for (int k = 0; k < n_steps; ++k) {
    const int I0 = J0 + k * kS;
    float* s_S = ring + (k % kStages) * dx_stage_floats<N>();  // C B^T, then S
    const float* s_dy = s_S + kS * kLD;
    const float* s_c = s_dy + kS * kLD;
    const float* s_cum_i = s_c + kS * LDN;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage k has landed; the stage it replaces is read
    issue(k + kStages - 1);
    float T[2][4];
    intra_tile(T, tS, s_S, s_dM, kLD, s_dy, s_x, s_cum_i, s_cum_j, I0, J0, sh.Q, true);
    // column sums of T: over the warp's 16 rows, then its 2 row warps in order
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = lane_sum<16, 4>(T[n][e] + T[n][e + 2]);
        if (tS.gq == 0) s_red[(tS.row0 / 16) * kT + tS.col(n, e)] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < kT)
      for (int w = 0; w < 2; ++w) col -= s_red[w * kT + threadIdx.x];
    warp_mma<N64, false>(acc_dx, t64, s_S, 1, kLD, s_dy, kLD, 1, kS);   // S^T dy
    // dM^T C, at N 128 one k-step at a time: 128 registers hold no more
    warp_mma<NB, false, N == 128 ? 1 : 2>(acc_db, tN, s_dM, 1, kLD, s_c, LDN, 1, kS);
  }
  __syncthreads();  // the walk's reads are done
  // the state terms, with B_J and g = dstate of this chunk in shared memory
  const long long st = ((static_cast<long long>(b) * sh.nC + c) * a.heads + h) * kP * N;
  stage(s_b, LDN, bp + J0 * a.b_s[1], a.b_s[1], kT, rows_j, N, a.vec);
  stage(s_ds, LDN, a.dstate + st, N, kP, kP, N, true);
  land();
  {
    float bg[N64][4];  // (B g^T)[j, p]
    zero(bg);
    warp_mma<N64, false>(bg, t64, s_b, LDN, 1, s_ds, 1, LDN, N);
#pragma unroll
    for (int n = 0; n < N64; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dx[n][e] = fmaf(s_w[t64.row(e)], bg[n][e], acc_dx[n][e]);
  }
  // (x g)[j, n], in two halves of the warp's columns (fewer live registers)
  constexpr int NH = NB / 2;
  float dwp[2] = {0.f, 0.f};  // sum_n B[j, n] (w_j (x g)[j, n]) over this thread's columns
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Tile th(tN.row0, tN.col0 + 8 * NH * half);
    float xg[NH][4];
    zero(xg);
    warp_mma<NH, false>(xg, th, s_x, kLD, 1, s_ds, LDN, 1, kP);
#pragma unroll
    for (int n = 0; n < NH; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = th.row(e);
        const float v = s_w[j] * xg[n][e];
        acc_db[NH * half + n][e] += v;
        dwp[e / 2] = fmaf(s_b[j * LDN + th.col(n, e)], v, dwp[e / 2]);
      }
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
    for (int n = 0; n < N64; ++n)
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
__host__ __device__ constexpr int dc_stage_floats() {  // C B^T / dM, x_J, B_J, cum_J
  return kT * kLDS + kS * kLD + kS * (N + 4) + kS;
}

template <int N>
__host__ __device__ constexpr int dc_smem_floats() {
  // dy_I, the ring (prev and C_I after the walk), cum_I, the row sums' 2 x
  // 64 partials
  return kT * kLD + kStages * dc_stage_floats<N>() + kT + 2 * kT;
}

// One block per (row tile I, head, chunk, b), the tiles with the most key
// tiles first; walks the keys J <= I, kS a ring stage.
template <int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dc_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDN = N + 4, NB = N / 16;
  static_assert(2 * kT * LDN <= kStages * dc_stage_floats<N>(), "prev and C_I fit the ring");
  const Shape sh(a);
  int blk = blockIdx.x;
  const int it = sh.nT - 1 - blk % sh.nT;
  blk /= sh.nT;
  const int h = blk % a.heads;
  blk /= a.heads;
  const int c = blk % sh.nC, b = blk / sh.nC;
  const int g = h / (a.heads / a.groups);
  float* s_dy = smem;                 // [kT][kLD]
  float* ring = s_dy + kT * kLD;      // kStages x (s_M, s_x, s_b, s_cum_j)
  float* s_cum_i = ring + kStages * dc_stage_floats<N>();  // [kT]
  float* s_red = s_cum_i + kT;        // [2][kT]
  float* s_prev = ring;               // [kP][LDN] after the walk
  float* s_c = ring + kP * LDN;       // [kT][LDN] after the walk

  const int I0 = it * kT, rows_i = min(kT, sh.Q - I0);
  const long long s0 = static_cast<long long>(c) * sh.Q;
  const float* xp = a.x + b * a.x_s[0] + s0 * a.x_s[1] + h * a.x_s[2];
  const float* dyp = a.dy + b * a.dy_s[0] + s0 * a.dy_s[1] + h * a.dy_s[2];
  const float* bp = a.B + b * a.b_s[0] + s0 * a.b_s[1] + g * a.b_s[2];
  const float* cp = a.C + b * a.c_s[0] + s0 * a.c_s[1] + g * a.c_s[2];
  const long long bhc = (static_cast<long long>(b * a.heads + h) * sh.nC + c) * sh.Q;
  const float* cum = a.cum + bhc;
  const float* cbp = a.cb + (static_cast<long long>(b * sh.nC + c) * a.groups + g) * sh.Qp * sh.Qp;
  const int n_steps = (min(I0 + kT, sh.Q) + kS - 1) / kS;
  // stage k: keys J0 = kS k.. in ring slot k % kStages
  auto issue = [&](int k) {
    if (k < n_steps) {
      float* slot = ring + (k % kStages) * dc_stage_floats<N>();
      const int J0 = k * kS, rows_j = min(kS, sh.Q - J0);
      stage(slot, kLDS, cbp + static_cast<long long>(I0) * sh.Qp + J0, sh.Qp, kT, kT, kS, true);
      stage(slot + kT * kLDS, kLD, xp + J0 * a.x_s[1], a.x_s[1], kS, rows_j, kP, a.vec);
      stage(slot + kT * kLDS + kS * kLD, LDN, bp + J0 * a.b_s[1], a.b_s[1], kS, rows_j, N, a.vec);
      stage_cum(slot + kT * kLDS + kS * kLD + kS * LDN, cum + J0, kS, rows_j);
    }
    cp_async_commit();
  };

  stage(s_dy, kLD, dyp + I0 * a.dy_s[1], a.dy_s[1], kT, rows_i, kP, a.vec);
  stage_cum(s_cum_i, cum + I0, kT, rows_i);
  for (int k = 0; k < kStages - 1; ++k) issue(k);  // the first with dy_I and cum_I
  // dy x^T's 64 x kS tile: warp w owns rows 16 (w % 4).. and keys 16 (w / 4)..
  const Tile tS(16 * ((threadIdx.x / 32) % 4), 16 * (threadIdx.x / 128)), tN(N);
  float acc[NB][4];
  zero(acc);
  float row = 0.f;  // rowsum(dS o S) of row I0 + threadIdx.x (threads < kT)
  for (int k = 0; k < n_steps; ++k) {
    const int J0 = k * kS;
    float* s_M = ring + (k % kStages) * dc_stage_floats<N>();  // C B^T, then dM
    const float* s_x = s_M + kT * kLDS;
    const float* s_b = s_x + kS * kLD;
    const float* s_cum_j = s_b + kS * LDN;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage k has landed; the stage it replaces is read
    issue(k + kStages - 1);
    // s_M holds C B^T: each thread reads its entries before it writes dM over them
    float T[2][4];
    intra_tile(T, tS, s_M, s_M, kLDS, s_dy, s_x, s_cum_i, s_cum_j, I0, J0, sh.Q, false);
    // row sums of T: over the warp's 16 keys, then its 2 key warps in order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) v += T[n][2 * r] + T[n][2 * r + 1];
      v = lane_sum<2, 1>(v);
      if (tS.tq == 0) s_red[(tS.col0 / 16) * kT + tS.row(2 * r)] = v;
    }
    __syncthreads();
    if (threadIdx.x < kT) row += s_red[threadIdx.x] + s_red[kT + threadIdx.x];
    warp_mma<NB, false>(acc, tN, s_M, kLDS, 1, s_b, LDN, 1, kS);  // dM B
  }
  __syncthreads();  // the walk's reads are done
  // the state term: (dy o e) prev, with prev of this chunk in shared memory
  const long long st = ((static_cast<long long>(b) * sh.nC + c) * a.heads + h) * kP * N;
  stage(s_prev, LDN, a.prev + st, N, kP, kP, N, true);
  stage(s_c, LDN, cp + I0 * a.c_s[1], a.c_s[1], kT, rows_i, N, a.vec);
  land();
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
int smem_bytes(int pass) {
  switch (pass) {
    case kDprev: return dprev_smem_floats<N>() * static_cast<int>(sizeof(float));
    case kDx: return dx_smem_floats<N>() * static_cast<int>(sizeof(float));
    case kDc: return dc_smem_floats<N>() * static_cast<int>(sizeof(float));
    default: return 0;
  }
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

// The dynamic shared memory, in bytes, of a block of a tensor pass (kDprev,
// kDx or kDc) at d_state n; 0 for another pass or an n with no instance.
extern "C" int ssd_scan_bwd_smem_bytes(int pass, int n) {
  switch (n) {
    case 64: return smem_bytes<64>(pass);
    case 128: return smem_bytes<128>(pass);
    default: return 0;
  }
}
