// Flash attention (GQA, causal / sliding window) for Hopper (sm_90a), CUDA C++:
// the forward and its backward.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `flash_attention_fwd` in
// src/repro/kernels/flash_attention/flash_attention.py.  The JAX package has
// no backward kernel (its gradient is the jnp custom VJP `_bwd_rule` in
// src/repro/models/blocked_attention.py); the backward here computes that
// rule.  Query i and key j sit at positions i and j; key j takes part in row
// i iff j < Sk, j <= i when causal, and i - j < window with a window.
//
// What it is given, unlike the TPU kernel:
//   * q, k, v (and out, dout) in the model layout [B, S, H, D], read through
//     strides: no transposed or padded copy (the JAX wrapper pads D 80 -> 128);
//   * the forward also writes the fp32 log-sum-exp [B, Hq, Sq] of each row's
//     scaled scores, which the backward uses to rebuild P.
//
// What bounds it: operations.  Per (query, key) pair that the mask keeps, the
// forward does 4*D flops (S = QK^T, O += PV) for no extra bytes, so at the
// training shapes it is far above the card's ~295 flops per byte.  This first
// version runs on the fp32 CUDA cores, not the tensor cores (67 TFLOP/s
// peak, against 989 for bf16 `wgmma`), and its design aims at keeping those
// busy and at not doing work the mask throws away:
//   * one block serves all G query heads of one kv head: its M = 64 rows are
//     M/G query positions x G heads, so each K/V tile is loaded once for the
//     group (the TPU grid (b, hq, iq, ik) loads it G times);
//   * K tiles that the causal mask or the window mask out completely are never
//     visited (the Pallas grid visits all nk tiles and masks them): at S 8192
//     and window 4096 about half the tiles are skipped.  Partly masked tiles
//     are masked per element;
//   * tiles are staged in shared memory as fp32 (transposed where the inner
//     loop wants a row per thread), and each thread keeps a 4 x 4 block of
//     the score tile in registers, so each shared-memory load feeds several
//     FMAs; strides are padded so that the 16 lanes that share a row of the
//     tile read distinct banks;
//   * fp32 online softmax in the log2 domain (scores pre-scaled by
//     scale * log2(e)); a row with no key in its mask gives 0.
// The backward runs three kernels: delta = sum_d dout * out per row; dK and
// dV per K tile (accumulated in registers over the G heads and the q tiles
// it needs, written once: no atomics); dQ per q tile over its K tiles.  Both
// rebuild P = exp(S - lse) per tile and skip fully masked tiles as the
// forward does.  Everything is deterministic.
// No tensor cores, TMA or cp.async yet: this is the first, simple version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBK = 64;  // keys per tile of the forward and the dQ kernel
constexpr int kMR = 64;  // query rows per tile of the dK/dV kernel

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

// Mirrored field for field by ctypes in ops.py.  Strides are in elements,
// in the order (batch, seq, head); the head dim is contiguous.
struct FlashArgs {
  int dtype;  // 0 = float32, 1 = bfloat16
  int batch, seq_q, seq_k, n_kv_heads, group, head_dim, causal, window;
  float scale;
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* out;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // [B, Hq, Sq]
  float* delta;  // [B, Hq, Sq]
  long long q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  void* stream;
};

namespace {

// Row r of a tile is position pos0 + r / grp of head head0 + r % grp (grp is
// G for query rows, 1 for key rows); positions >= limit read as zero.
struct Rows {
  long long base;
  int pos0, head0, grp, limit;
  long long s_s, s_h;
};

__device__ __forceinline__ int row_pos(const Rows& m, int r) { return m.pos0 + r / m.grp; }

// dst[d * ld + r] = mul * row_r[d] for the `rows` rows of a tile: 16-byte
// loads along d, consecutive threads on consecutive rows (conflict-free
// shared-memory stores).
template <typename T, int D, int NT>
__device__ __forceinline__ void load_t(float* __restrict__ dst, int ld, int rows,
                                       const T* __restrict__ src, const Rows& m, float mul) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = D / VEC;
  for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
    const int r = idx % rows;
    const int c = idx / rows;
    const int pos = row_pos(m, r);
    float vals[VEC];
    if (pos < m.limit) {
      const T* p = src + m.base + pos * m.s_s + (m.head0 + r % m.grp) * m.s_h + c * VEC;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = to_float(e[j]) * mul;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[(c * VEC + j) * ld + r] = vals[j];
  }
}

__device__ __forceinline__ bool keep(const FlashArgs& a, int qpos, int kpos) {
  return qpos < a.seq_q && kpos < a.seq_k && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || qpos - kpos < a.window);
}

// Max / sum over the 16 lanes that share a row (tx = threadIdx.x % 16).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The K tiles a block of query positions [q_lo, q_hi] must visit.
__device__ __forceinline__ void key_range(const FlashArgs& a, int q_lo, int q_hi, int& k_first,
                                          int& k_last) {
  int lo = 0, hi = a.seq_k - 1;
  if (a.causal) hi = min(hi, q_hi);
  if (a.window > 0) lo = max(0, q_lo - a.window + 1);
  k_first = (lo / kBK) * kBK;
  k_last = hi;
}

// ---------------------------------------------------------------- forward
// grid (ceil(Sq / (M/G)), B*Hkv), M*4 threads.  Thread (ty, tx) owns rows
// ty*4..ty*4+3 of the tile and keys tx + 16j of each K tile.
template <typename T, int D, int M>
__global__ void __launch_bounds__(M * 4) flash_fwd_kernel(const FlashArgs a) {
  constexpr int NT = M * 4;
  constexpr int CPT = D / 16;
  constexpr int LDK = kBK + 1;
  constexpr int LDP = M + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [D][M], pre-scaled by scale*log2(e)
  float* Kt = Qt + D * M;      // [D][LDK]
  float* Vt = Kt + D * LDK;    // [D][LDK]
  float* Ps = Vt + D * LDK;    // [kBK][LDP]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = blockIdx.y / a.n_kv_heads, h = blockIdx.y % a.n_kv_heads;
  const int G = a.group, hq = a.n_kv_heads * G;
  const int q0 = blockIdx.x * (M / G);

  const Rows qrows{b * a.q_s[0], q0, h * G, G, a.seq_q, a.q_s[1], a.q_s[2]};
  load_t<T, D, NT>(Qt, M, M, q, qrows, a.scale * kLog2e);

  int qpos[4];
  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = row_pos(qrows, ty * 4 + i);
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  int k_first, k_last;
  key_range(a, q0, min(q0 + M / G, a.seq_q) - 1, k_first, k_last);

  for (int k0 = k_first; k0 <= k_last; k0 += kBK) {
    __syncthreads();  // the previous tile's Vt and Ps are consumed
    load_t<T, D, NT>(Kt, LDK, kBK, k, Rows{b * a.k_s[0], k0, h, 1, a.seq_k, a.k_s[1], a.k_s[2]}, 1.f);
    load_t<T, D, NT>(Vt, LDK, kBK, v, Rows{b * a.v_s[0], k0, h, 1, a.seq_k, a.v_s[1], a.v_s[2]}, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = ld4(Qt + d * M + ty * 4);
      const float* kr = Kt + d * LDK + tx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = kr[16 * j];
        s[0][j] = fmaf(qv.x, kv, s[0][j]);
        s[1][j] = fmaf(qv.y, kv, s[1][j]);
        s[2][j] = fmaf(qv.z, kv, s[2][j]);
        s[3][j] = fmaf(qv.w, kv, s[3][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!keep(a, qpos[i], k0 + tx + 16 * j)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // row masked so far
      const float alpha = exp2f(m_i[i] - m_use);              // 0 while m_i is -inf
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);  // 0 where masked
        rs += s[i][j];
      }
      l_i[i] = l_i[i] * alpha + row_sum(rs);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      m_i[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * LDP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pv = ld4(Ps + kk * LDP + ty * 4);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vt[(tx + 16 * c) * LDK + kk];
        acc[0][c] = fmaf(pv.x, vv, acc[0][c]);
        acc[1][c] = fmaf(pv.y, vv, acc[1][c]);
        acc[2][c] = fmaf(pv.z, vv, acc[2][c]);
        acc[3][c] = fmaf(pv.w, vv, acc[3][c]);
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] >= a.seq_q) continue;
    const int head = h * G + (ty * 4 + i) % G;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
    T* orow = out + b * a.o_s[0] + qpos[i] * a.o_s[1] + head * a.o_s[2];
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = from_float<T>(acc[i][c] * inv);
    if (tx == 0)
      a.lse[(static_cast<long long>(b) * hq + head) * a.seq_q + qpos[i]] =
          l_i[i] > 0.f ? (m_i[i] + log2f(l_i[i])) * kLn2 : -INFINITY;
  }
}

// ---------------------------------------------------------------- backward
// delta[b, head, pos] = sum_d dout * out; one warp per row, 8 rows a block.
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const FlashArgs a) {
  const int hq = a.n_kv_heads * a.group;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.batch) * a.seq_q * hq) return;
  const int b = static_cast<int>(row / (static_cast<long long>(a.seq_q) * hq));
  const int rem = static_cast<int>(row % (static_cast<long long>(a.seq_q) * hq));
  const int pos = rem / hq, head = rem % hq;
  const T* o = static_cast<const T*>(a.o) + b * a.o_s[0] + pos * a.o_s[1] + head * a.o_s[2];
  const T* g = static_cast<const T*>(a.dout) + b * a.do_s[0] + pos * a.do_s[1] + head * a.do_s[2];
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(to_float(o[d]), to_float(g[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) a.delta[(static_cast<long long>(b) * hq + head) * a.seq_q + pos] = sum;
}

// lse (as log2) and delta of the `rows` rows of a query tile, into shared
// memory; rows past Sq get lse +inf (P = 0).
__device__ __forceinline__ void load_row_stats(const FlashArgs& a, const Rows& m, int rows, int b,
                                               float* lse2, float* dl) {
  const int hq = a.n_kv_heads * a.group;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int pos = row_pos(m, r);
    const long long idx = (static_cast<long long>(b) * hq + m.head0 + r % m.grp) * a.seq_q + pos;
    lse2[r] = pos < a.seq_q ? a.lse[idx] * kLog2e : INFINITY;
    dl[r] = pos < a.seq_q ? a.delta[idx] : 0.f;
  }
}

// dK, dV.  grid (ceil(Sk / BKV), B*Hkv), BKV*4 threads.  Thread (ty, tx)
// owns keys ty*4..ty*4+3 and query rows tx + 16j of each q tile of kMR rows
// (kMR/G positions x G heads).
template <typename T, int D, int BKV>
__global__ void __launch_bounds__(BKV * 4) flash_bwd_dkv_kernel(const FlashArgs a) {
  constexpr int NT = BKV * 4;
  constexpr int CPT = D / 16;
  constexpr int LDQ = kMR + 1;
  constexpr int LDP = BKV + 4;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;             // [D][BKV]
  float* Vt = Kt + D * BKV;     // [D][BKV]
  float* Qt = Vt + D * BKV;     // [D][LDQ]
  float* Ot = Qt + D * LDQ;     // [D][LDQ]: dout
  float* Ps = Ot + D * LDQ;     // [kMR][LDP]
  float* Ds = Ps + kMR * LDP;   // [kMR][LDP]: dS
  float* lse2 = Ds + kMR * LDP; // [kMR]
  float* dl = lse2 + kMR;       // [kMR]

  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = blockIdx.y / a.n_kv_heads, h = blockIdx.y % a.n_kv_heads;
  const int G = a.group;
  const int k0 = blockIdx.x * BKV;
  const float c2 = a.scale * kLog2e;

  load_t<T, D, NT>(Kt, BKV, BKV, static_cast<const T*>(a.k),
                   Rows{b * a.k_s[0], k0, h, 1, a.seq_k, a.k_s[1], a.k_s[2]}, 1.f);
  load_t<T, D, NT>(Vt, BKV, BKV, static_cast<const T*>(a.v),
                   Rows{b * a.v_s[0], k0, h, 1, a.seq_k, a.v_s[1], a.v_s[2]}, 1.f);

  int kpos[4];
  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kpos[i] = k0 + ty * 4 + i;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;
  }
  const int k_last = min(k0 + BKV, a.seq_k) - 1;
  const int q_lo = a.causal ? k0 : 0;
  int q_hi = a.seq_q - 1;
  if (a.window > 0) q_hi = min(q_hi, k_last + a.window - 1);
  const int bq = kMR / G;

  for (int q0 = (q_lo / bq) * bq; q0 <= q_hi; q0 += bq) {
    __syncthreads();  // the previous q tile is consumed
    const Rows qrows{b * a.q_s[0], q0, h * G, G, a.seq_q, a.q_s[1], a.q_s[2]};
    load_t<T, D, NT>(Qt, LDQ, kMR, q, qrows, 1.f);
    load_t<T, D, NT>(Ot, LDQ, kMR, dout,
                     Rows{b * a.do_s[0], q0, h * G, G, a.seq_q, a.do_s[1], a.do_s[2]}, 1.f);
    load_row_stats(a, qrows, kMR, b, lse2, dl);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 kv = ld4(Kt + d * BKV + ty * 4);
      const float4 vv = ld4(Vt + d * BKV + ty * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float qv = Qt[d * LDQ + tx + 16 * j];
        const float ov = Ot[d * LDQ + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(at(kv, i), qv, s[i][j]);
          dp[i][j] = fmaf(at(vv, i), ov, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
      const int qp = row_pos(qrows, r);
      const float ls = lse2[r], dlr = dl[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = keep(a, qp, kpos[i]) ? exp2f(s[i][j] * c2 - ls) : 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dlr);
      }
      *reinterpret_cast<float4*>(Ps + r * LDP + ty * 4) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(Ds + r * LDP + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kMR; ++r) {
      const float4 pv = ld4(Ps + r * LDP + ty * 4);
      const float4 sv = ld4(Ds + r * LDP + ty * 4);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float ov = Ot[(tx + 16 * c) * LDQ + r];
        const float qv = Qt[(tx + 16 * c) * LDQ + r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(at(pv, i), ov, dv[i][c]);
          dk[i][c] = fmaf(at(sv, i), qv, dk[i][c]);
        }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kpos[i] >= a.seq_k) continue;
    T* krow = dkp + b * a.dk_s[0] + kpos[i] * a.dk_s[1] + h * a.dk_s[2];
    T* vrow = dvp + b * a.dv_s[0] + kpos[i] * a.dv_s[1] + h * a.dv_s[2];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      krow[tx + 16 * c] = from_float<T>(dk[i][c] * a.scale);
      vrow[tx + 16 * c] = from_float<T>(dv[i][c]);
    }
  }
}

// dQ.  grid (ceil(Sq / (M/G)), B*Hkv), M*4 threads; the forward's tiling.
template <typename T, int D, int M>
__global__ void __launch_bounds__(M * 4) flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int NT = M * 4;
  constexpr int CPT = D / 16;
  constexpr int LDK = kBK + 1;
  constexpr int LDS = M + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [D][M]
  float* Ot = Qt + D * M;      // [D][M]: dout
  float* Kt = Ot + D * M;      // [D][LDK]
  float* Vt = Kt + D * LDK;    // [D][LDK]
  float* Ds = Vt + D * LDK;    // [kBK][LDS]: dS
  float* lse2 = Ds + kBK * LDS;
  float* dl = lse2 + M;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = blockIdx.y / a.n_kv_heads, h = blockIdx.y % a.n_kv_heads;
  const int G = a.group;
  const int q0 = blockIdx.x * (M / G);
  const float c2 = a.scale * kLog2e;

  const Rows qrows{b * a.q_s[0], q0, h * G, G, a.seq_q, a.q_s[1], a.q_s[2]};
  load_t<T, D, NT>(Qt, M, M, static_cast<const T*>(a.q), qrows, 1.f);
  load_t<T, D, NT>(Ot, M, M, static_cast<const T*>(a.dout),
                   Rows{b * a.do_s[0], q0, h * G, G, a.seq_q, a.do_s[1], a.do_s[2]}, 1.f);
  load_row_stats(a, qrows, M, b, lse2, dl);

  int qpos[4];
  float dq[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = row_pos(qrows, ty * 4 + i);
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;
  }
  int k_first, k_last;
  key_range(a, q0, min(q0 + M / G, a.seq_q) - 1, k_first, k_last);

  for (int k0 = k_first; k0 <= k_last; k0 += kBK) {
    __syncthreads();
    load_t<T, D, NT>(Kt, LDK, kBK, static_cast<const T*>(a.k),
                     Rows{b * a.k_s[0], k0, h, 1, a.seq_k, a.k_s[1], a.k_s[2]}, 1.f);
    load_t<T, D, NT>(Vt, LDK, kBK, static_cast<const T*>(a.v),
                     Rows{b * a.v_s[0], k0, h, 1, a.seq_k, a.v_s[1], a.v_s[2]}, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = ld4(Qt + d * M + ty * 4);
      const float4 ov = ld4(Ot + d * M + ty * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = Kt[d * LDK + tx + 16 * j];
        const float vv = Vt[d * LDK + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(at(qv, i), kv, s[i][j]);
          dp[i][j] = fmaf(at(ov, i), vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ls = lse2[ty * 4 + i], dlr = dl[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep(a, qpos[i], k0 + tx + 16 * j) ? exp2f(s[i][j] * c2 - ls) : 0.f;
        dp[i][j] = p * (dp[i][j] - dlr);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ds + (tx + 16 * j) * LDS + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 sv = ld4(Ds + kk * LDS + ty * 4);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = Kt[(tx + 16 * c) * LDK + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(at(sv, i), kv, dq[i][c]);
      }
    }
  }

  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] >= a.seq_q) continue;
    const int head = h * G + (ty * 4 + i) % G;
    T* row = dqp + b * a.dq_s[0] + qpos[i] * a.dq_s[1] + head * a.dq_s[2];
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[tx + 16 * c] = from_float<T>(dq[i][c] * a.scale);
  }
}

// ------------------------------------------------------------------ host
template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, const FlashArgs& a) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(a.stream)>>>(a);
  return cudaGetLastError();
}

unsigned cdiv(long long n, int d) { return static_cast<unsigned>((n + d - 1) / d); }

template <typename T, int D>
int fwd(const FlashArgs& a) {
  constexpr int M = 64;
  const size_t smem = (D * M + 2 * D * (kBK + 1) + kBK * (M + 4)) * sizeof(float);
  const dim3 grid(cdiv(a.seq_q, M / a.group), a.batch * a.n_kv_heads);
  return static_cast<int>(launch(flash_fwd_kernel<T, D, M>, grid, M * 4, smem, a));
}

template <typename T, int D>
int bwd(const FlashArgs& a) {
  // D 256 takes half tiles so that a block's fp32 tiles fit in 227 KB
  constexpr int M = D > 128 ? 32 : 64;
  constexpr int BKV = D > 128 ? 32 : 64;
  const long long rows = static_cast<long long>(a.batch) * a.seq_q * a.n_kv_heads * a.group;
  cudaError_t err = launch(flash_bwd_delta_kernel<T, D>, dim3(cdiv(rows, 8)), 256, 0, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_kv =
      (2 * D * BKV + 2 * D * (kMR + 1) + 2 * kMR * (BKV + 4) + 2 * kMR) * sizeof(float);
  err = launch(flash_bwd_dkv_kernel<T, D, BKV>, dim3(cdiv(a.seq_k, BKV), a.batch * a.n_kv_heads),
               BKV * 4, smem_kv, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_q = (2 * D * M + 2 * D * (kBK + 1) + kBK * (M + 4) + 2 * M) * sizeof(float);
  err = launch(flash_bwd_dq_kernel<T, D, M>, dim3(cdiv(a.seq_q, M / a.group), a.batch * a.n_kv_heads),
               M * 4, smem_q, a);
  return static_cast<int>(err);
}

template <typename T, bool BWD>
int dispatch_dim(const FlashArgs& a) {
  switch (a.head_dim) {
    case 64: return BWD ? bwd<T, 64>(a) : fwd<T, 64>(a);
    case 80: return BWD ? bwd<T, 80>(a) : fwd<T, 80>(a);
    case 128: return BWD ? bwd<T, 128>(a) : fwd<T, 128>(a);
    case 256: return BWD ? bwd<T, 256>(a) : fwd<T, 256>(a);
    default: return -1;
  }
}

template <bool BWD>
int dispatch(const FlashArgs* a) {
  switch (a->dtype) {
    case 0: return dispatch_dim<float, BWD>(*a);
    case 1: return dispatch_dim<__nv_bfloat16, BWD>(*a);
    default: return -1;
  }
}

}  // namespace

// Each returns cudaGetLastError() after its launches, or -1 for a shape
// this build has no instance for (the wrapper checks that first).
extern "C" int flash_attention_fwd_launch(const FlashArgs* a) { return dispatch<false>(a); }
extern "C" int flash_attention_bwd_launch(const FlashArgs* a) { return dispatch<true>(a); }
