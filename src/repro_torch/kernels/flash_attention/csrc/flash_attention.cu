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
// forward does 4*D flops (S = QK^T, O += PV) and the backward 10*D (S, dP,
// dV, dK, dQ) for no extra bytes, so at the training shapes both are far
// above the card's ~295 flops per byte.
//
// bf16 (the model's path) runs on the tensor cores: `mma.sync` m16n8k16 with
// bf16 operands and fp32 accumulators, fed by `ldmatrix` from bf16 tiles in
// shared memory (rows padded by 16 bytes, so the 8 rows an `ldmatrix` phase
// reads fall on distinct banks).  K/V (forward, dQ) and Q/dO (dK/dV) tiles
// come in through a ring of two stages with `cp.async`: tile t+1 is in
// flight while tile t is computed; rows past the sequence are zero-filled.
//   * Forward: a block serves all G query heads of one kv head: its M rows
//     (M/G positions x G heads, M = 128 where the grid fills the card, else
//     64) are 16 per warp, so each K/V tile is loaded once for the group.
//     S stays in registers; the online softmax (fp32, log2 domain, scores
//     scaled by scale*log2(e) after the product) runs on the accumulator
//     fragments, and P is rounded to bf16 in registers and fed as the A
//     operand of P V, with no shared-memory round trip.
//   * Backward: delta = sum_d dout * out per row; dK/dV per tile of keys (16
//     a warp; at D 256 two warps split the D columns of one 16-key slice and
//     both compute its S^T and dP^T), looping over the 32-row q tiles the
//     mask needs: S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T Q, accumulated in fp32 registers and written once; dQ per q
//     tile over its K tiles (dQ += dS K), recomputing S and dP.  No atomics,
//     deterministic.  The dQ kernel's recomputation makes the backward
//     execute 14*D flops per pair against the bound's 10*D: the price of
//     having no atomics.
//   * Rounding points beyond the output's: P (forward, and the dV product)
//     and dS (the dK and dQ products) are rounded to bf16 as A operands; row
//     sums, maxima and every accumulator stay fp32.  ref.py's `p_dtype`,
//     with the forward's key tile (`kernel_key_tile`), reproduces these
//     points for the tests.
//   * K tiles that the causal mask or the window mask out completely are
//     never visited, a warp skips a tile that masks all its rows, and the
//     per-element mask is applied only on tiles that the diagonal, the
//     window edge or the sequence's end crosses.
//   * What bounds these kernels now: `mma.sync` reaches a fraction of the
//     `wgmma` peak, and the softmax's exp2 and the masks run on the CUDA
//     cores between the products (no warp specialisation, no TMA yet).
// fp32 inputs keep the first version on the CUDA cores (fp32 FMAs over fp32
// tiles, 4 x 4 register blocks per thread, P and dS through shared memory),
// so that fp32 callers keep fp32 products; no bf16 call reaches it.

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
template <int D, int NT>
__device__ __forceinline__ void load_t(float* __restrict__ dst, int ld, int rows,
                                       const float* __restrict__ src, const Rows& m, float mul) {
  constexpr int VEC = 4;
  constexpr int CH = D / VEC;
  for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
    const int r = idx % rows;
    const int c = idx / rows;
    const int pos = row_pos(m, r);
    float vals[VEC];
    if (pos < m.limit) {
      const float* p = src + m.base + pos * m.s_s + (m.head0 + r % m.grp) * m.s_h + c * VEC;
      const float4 raw = __ldg(reinterpret_cast<const float4*>(p));
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = e[j] * mul;
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

// The K tiles of BK keys a block of query positions [q_lo, q_hi] must visit.
template <int BK = kBK>
__device__ __forceinline__ void key_range(const FlashArgs& a, int q_lo, int q_hi, int& k_first,
                                          int& k_last) {
  int lo = 0, hi = a.seq_k - 1;
  if (a.causal) hi = min(hi, q_hi);
  if (a.window > 0) lo = max(0, q_lo - a.window + 1);
  k_first = (lo / BK) * BK;
  k_last = hi;
}

// ---------------------------------------------------------------- forward
// grid (ceil(Sq / (M/G)), B*Hkv), M*4 threads.  Thread (ty, tx) owns rows
// ty*4..ty*4+3 of the tile and keys tx + 16j of each K tile.
template <int D, int M>
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

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = blockIdx.y / a.n_kv_heads, h = blockIdx.y % a.n_kv_heads;
  const int G = a.group, hq = a.n_kv_heads * G;
  const int q0 = blockIdx.x * (M / G);

  const Rows qrows{b * a.q_s[0], q0, h * G, G, a.seq_q, a.q_s[1], a.q_s[2]};
  load_t<D, NT>(Qt, M, M, q, qrows, a.scale * kLog2e);

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
    load_t<D, NT>(Kt, LDK, kBK, k, Rows{b * a.k_s[0], k0, h, 1, a.seq_k, a.k_s[1], a.k_s[2]}, 1.f);
    load_t<D, NT>(Vt, LDK, kBK, v, Rows{b * a.v_s[0], k0, h, 1, a.seq_k, a.v_s[1], a.v_s[2]}, 1.f);
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

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] >= a.seq_q) continue;
    const int head = h * G + (ty * 4 + i) % G;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
    float* orow = out + b * a.o_s[0] + qpos[i] * a.o_s[1] + head * a.o_s[2];
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
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
template <int D, int BKV>
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

  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = blockIdx.y / a.n_kv_heads, h = blockIdx.y % a.n_kv_heads;
  const int G = a.group;
  const int k0 = blockIdx.x * BKV;
  const float c2 = a.scale * kLog2e;

  load_t<D, NT>(Kt, BKV, BKV, static_cast<const float*>(a.k),
                   Rows{b * a.k_s[0], k0, h, 1, a.seq_k, a.k_s[1], a.k_s[2]}, 1.f);
  load_t<D, NT>(Vt, BKV, BKV, static_cast<const float*>(a.v),
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
    load_t<D, NT>(Qt, LDQ, kMR, q, qrows, 1.f);
    load_t<D, NT>(Ot, LDQ, kMR, dout,
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

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kpos[i] >= a.seq_k) continue;
    float* krow = dkp + b * a.dk_s[0] + kpos[i] * a.dk_s[1] + h * a.dk_s[2];
    float* vrow = dvp + b * a.dv_s[0] + kpos[i] * a.dv_s[1] + h * a.dv_s[2];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      krow[tx + 16 * c] = dk[i][c] * a.scale;
      vrow[tx + 16 * c] = dv[i][c];
    }
  }
}

// dQ.  grid (ceil(Sq / (M/G)), B*Hkv), M*4 threads; the forward's tiling.
template <int D, int M>
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
  load_t<D, NT>(Qt, M, M, static_cast<const float*>(a.q), qrows, 1.f);
  load_t<D, NT>(Ot, M, M, static_cast<const float*>(a.dout),
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
    load_t<D, NT>(Kt, LDK, kBK, static_cast<const float*>(a.k),
                     Rows{b * a.k_s[0], k0, h, 1, a.seq_k, a.k_s[1], a.k_s[2]}, 1.f);
    load_t<D, NT>(Vt, LDK, kBK, static_cast<const float*>(a.v),
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

  float* dqp = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] >= a.seq_q) continue;
    const int head = h * G + (ty * 4 + i) % G;
    float* row = dqp + b * a.dq_s[0] + qpos[i] * a.dq_s[1] + head * a.dq_s[2];
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[tx + 16 * c] = dq[i][c] * a.scale;
  }
}

// ============================================== bf16 on the tensor cores
using bf16 = __nv_bfloat16;

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

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment addressing.  A warp's accumulator c[n] of an m16n8 product holds
// rows lane/4 (c[0], c[1]) and lane/4 + 8 (c[2], c[3]), columns
// 8n + 2*(lane%4) + {0, 1}.
//   a_frag: the A operand (16 rows x 16 of k) of rows `base` (ld elements).
__device__ __forceinline__ void a_frag(uint32_t (&r)[4], const bf16* base, int ld, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, base + (lane % 16) * ld + k0 + (lane / 16) * 8);
}
//   b_pair: B operands of two n-tiles (n rows n0..n0+15 of a [n][k] tile):
//   r[0], r[1] for n-tile n0/8 and r[2], r[3] for the next.
__device__ __forceinline__ void b_pair(uint32_t (&r)[4], const bf16* base, int ld, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, base + (n0 + (lane / 16) * 8 + lane % 8) * ld + k0 + ((lane / 8) % 2) * 8);
}
//   b_pair_t: the same from a [k][n] tile (transposed on the way in).
__device__ __forceinline__ void b_pair_t(uint32_t (&r)[4], const bf16* base, int ld, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(r, base + (k0 + ((lane / 8) % 2) * 8 + lane % 8) * ld + n0 + (lane / 16) * 8);
}
//   c_to_a: accumulator columns 16j..16j+15 as the bf16 A operand of k-step j.
__device__ __forceinline__ void c_to_a(uint32_t (&r)[4], const float (&c0)[4], const float (&c1)[4]) {
  r[0] = pack_bf16(c0[0], c0[1]);
  r[1] = pack_bf16(c0[2], c0[3]);
  r[2] = pack_bf16(c1[0], c1[1]);
  r[3] = pack_bf16(c1[2], c1[3]);
}

// acc[n] += A (16 rows at `a`) * B^T over D, B's rows n at `b` ([n][D]).
template <int D, int NN>
__device__ __forceinline__ void mma_abt(float (&acc)[NN][4], const bf16* a, const bf16* b, int ld) {
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t af[4];
    a_frag(af, a, ld, kk);
#pragma unroll
    for (int np = 0; np < NN / 2; ++np) {
      uint32_t bf[4];
      b_pair(bf, b, ld, np * 16, kk);
      mma16816(acc[2 * np], af, bf[0], bf[1]);
      mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[n] += P * B over the 16*NK columns of p (accumulator layout), B's
// rows at `b` ([k][ld]), columns n0.. n0 + 8*DN - 1.
template <int NK, int DN>
__device__ __forceinline__ void mma_pb(float (&acc)[DN][4], const float (&p)[NK][4], const bf16* b,
                                       int ld, int n0) {
#pragma unroll
  for (int j = 0; j < NK / 2; ++j) {
    uint32_t pa[4];
    c_to_a(pa, p[2 * j], p[2 * j + 1]);
#pragma unroll
    for (int np = 0; np < DN / 2; ++np) {
      uint32_t bf[4];
      b_pair_t(bf, b, ld, j * 16, n0 + np * 16);
      mma16816(acc[2 * np], pa, bf[0], bf[1]);
      mma16816(acc[2 * np + 1], pa, bf[2], bf[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// The `rows` rows of a tile into dst[r * (D + 8) + d] with cp.async, 16
// bytes a thread, consecutive threads along a row; rows past the sequence
// are zero-filled.
template <int D, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, int rows, const bf16* src, const Rows& m) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const int pos = row_pos(m, r);
    const bool ok = pos < m.limit;
    const bf16* p = ok ? src + m.base + pos * m.s_s + (m.head0 + r % m.grp) * m.s_h + c * 8 : src;
    cp_async16(dst + r * (D + 8) + c * 8, p, ok);
  }
}

// Whether a tile of positions [q_lo, q_hi] x keys [k_lo, k_hi] is masked
// out completely, and whether any pair of it is masked (q_hi < Sq).
__device__ __forceinline__ bool tile_empty(const FlashArgs& a, int q_lo, int q_hi, int k_lo, int k_hi) {
  return q_lo >= a.seq_q || k_lo >= a.seq_k || (a.causal && k_lo > q_hi) ||
         (a.window > 0 && q_lo - k_hi >= a.window);
}
__device__ __forceinline__ bool tile_partial(const FlashArgs& a, int q_lo, int q_hi, int k_lo, int k_hi) {
  return k_hi >= a.seq_k || (a.causal && k_hi > q_lo) || (a.window > 0 && q_hi - k_lo >= a.window);
}

// ---------------------------------------------------------- bf16 forward
// grid (ceil(Sq / (M/G)), B*Hkv), M*2 threads: warp w owns rows 16w..16w+15.
template <int D, int M>
struct FwdCfg {
  static constexpr int NT = M * 2;
  static constexpr int BK = D > 128 ? 32 : 64;  // keys per tile
  static constexpr int LD = D + 8;
  static constexpr bool Q_REGS = D <= 80;  // Q's A fragments live in registers
  static constexpr size_t SMEM = static_cast<size_t>(M + 4 * BK) * LD * sizeof(bf16);
};

template <int D, int M>
__global__ void __launch_bounds__(M * 2, D <= 128 ? 2 : 1) flash_fwd_mma_kernel(const FlashArgs a) {
  using C = FwdCfg<D, M>;
  constexpr int BK = C::BK, LD = C::LD, NN = BK / 8, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [M][LD]
  bf16* KV = Qs + M * LD;                        // stage s: K [BK][LD], then V [BK][LD]

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / a.n_kv_heads, h = blockIdx.y % a.n_kv_heads;
  const int G = a.group, hq = a.n_kv_heads * G;
  const int q0 = blockIdx.x * (M / G);
  const float c2 = a.scale * kLog2e;

  const Rows qrows{b * a.q_s[0], q0, h * G, G, a.seq_q, a.q_s[1], a.q_s[2]};
  load_rows<D, C::NT>(Qs, M, q, qrows);
  cp_async_commit();
  int k_first, k_last;
  key_range<BK>(a, q0, min(q0 + M / G, a.seq_q) - 1, k_first, k_last);
  auto load_kv = [&](int k0, int stage) {
    bf16* ks = KV + stage * 2 * BK * LD;
    load_rows<D, C::NT>(ks, BK, k, Rows{b * a.k_s[0], k0, h, 1, a.seq_k, a.k_s[1], a.k_s[2]});
    load_rows<D, C::NT>(ks + BK * LD, BK, v, Rows{b * a.v_s[0], k0, h, 1, a.seq_k, a.v_s[1], a.v_s[2]});
  };
  if (k_first <= k_last) load_kv(k_first, 0);
  cp_async_commit();

  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int qpos[2] = {q0 + r0 / G, q0 + (r0 + 8) / G};
  const int w_lo = q0 + warp * 16 / G;
  const int w_hi = min(q0 + (warp * 16 + 15) / G, a.seq_q - 1);
  const bf16* Qw = Qs + warp * 16 * LD;

  cp_async_wait<1>();  // Q is in
  __syncthreads();
  uint32_t qf[C::Q_REGS ? D / 16 : 1][4];
  if constexpr (C::Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) a_frag(qf[kk], Qw, LD, kk * 16);
  }

  float o[DN][4];
  zero(o);
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};  // l_i: this thread's share

  int stage = 0;
  for (int k0 = k_first; k0 <= k_last; k0 += BK, stage ^= 1) {
    if (k0 + BK <= k_last) load_kv(k0 + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = KV + stage * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;
    if (!tile_empty(a, w_lo, w_hi, k0, k0 + BK - 1)) {
      float s[NN][4];
      zero(s);
      if constexpr (C::Q_REGS) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
          for (int np = 0; np < NN / 2; ++np) {
            uint32_t bf[4];
            b_pair(bf, Ks, LD, np * 16, kk * 16);
            mma16816(s[2 * np], qf[kk], bf[0], bf[1]);
            mma16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
          }
      } else {
        mma_abt<D, NN>(s, Qw, Ks, LD);
      }
      const bool partial = tile_partial(a, w_lo, w_hi, k0, k0 + BK - 1);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * c2;
          if (partial && !keep(a, qpos[e / 2], k0 + 8 * n + 2 * (lane % 4) + (e & 1))) x = -INFINITY;
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_i[i], mx[i]);
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;  // row masked so far
        alpha[i] = exp2f(m_i[i] - m_use[i]);           // 0 while m_i is -inf
        m_i[i] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - m_use[e / 2]);  // 0 where masked
          rs[e / 2] += s[n][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + rs[i];
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      mma_pb<NN, DN>(o, s, Vs, LD, 0);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (qpos[i] >= a.seq_q) continue;
    const int head = h * G + (r0 + 8 * i) % G;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* orow = out + b * a.o_s[0] + qpos[i] * a.o_s[1] + head * a.o_s[2] + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (lane % 4 == 0)
      a.lse[(static_cast<long long>(b) * hq + head) * a.seq_q + qpos[i]] =
          l > 0.f ? (m_i[i] + log2f(l)) * kLn2 : -INFINITY;
  }
}

// ---------------------------------------------------------- bf16 backward
// lse as log2 and delta of row r of a query tile; a row past Sq or with no
// key in its mask (lse -inf) gets +inf, so that P = exp2(S - lse) is 0.
__device__ __forceinline__ void row_stats(const FlashArgs& a, const Rows& m, int r, int b, float& lse2,
                                          float& dl) {
  const int pos = row_pos(m, r);
  lse2 = INFINITY;
  dl = 0.f;
  if (pos < a.seq_q) {
    const long long idx =
        (static_cast<long long>(b) * a.n_kv_heads * a.group + m.head0 + r % m.grp) * a.seq_q + pos;
    const float l = a.lse[idx];
    if (l != -INFINITY) lse2 = l * kLog2e;
    dl = a.delta[idx];
  }
}

// dQ.  grid (ceil(Sq / (M/G)), B*Hkv), M*2 threads; the forward's tiling.
template <int D, int M>
struct DqCfg {
  static constexpr int NT = M * 2;
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int LD = D + 8;
  static constexpr size_t SMEM = static_cast<size_t>(2 * M + 4 * BK) * LD * sizeof(bf16);
};

template <int D, int M>
__global__ void __launch_bounds__(M * 2, D <= 80 ? 2 : 1) flash_bwd_dq_mma_kernel(const FlashArgs a) {
  using C = DqCfg<D, M>;
  constexpr int BK = C::BK, LD = C::LD, NN = BK / 8, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [M][LD]
  bf16* Os = Qs + M * LD;                        // [M][LD]: dout
  bf16* KV = Os + M * LD;                        // stage s: K [BK][LD], then V [BK][LD]

  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / a.n_kv_heads, h = blockIdx.y % a.n_kv_heads;
  const int G = a.group;
  const int q0 = blockIdx.x * (M / G);
  const float c2 = a.scale * kLog2e;

  const Rows qrows{b * a.q_s[0], q0, h * G, G, a.seq_q, a.q_s[1], a.q_s[2]};
  load_rows<D, C::NT>(Qs, M, static_cast<const bf16*>(a.q), qrows);
  load_rows<D, C::NT>(Os, M, static_cast<const bf16*>(a.dout),
                      Rows{b * a.do_s[0], q0, h * G, G, a.seq_q, a.do_s[1], a.do_s[2]});
  int k_first, k_last;
  key_range<BK>(a, q0, min(q0 + M / G, a.seq_q) - 1, k_first, k_last);
  auto load_kv = [&](int k0, int stage) {
    bf16* ks = KV + stage * 2 * BK * LD;
    load_rows<D, C::NT>(ks, BK, k, Rows{b * a.k_s[0], k0, h, 1, a.seq_k, a.k_s[1], a.k_s[2]});
    load_rows<D, C::NT>(ks + BK * LD, BK, v, Rows{b * a.v_s[0], k0, h, 1, a.seq_k, a.v_s[1], a.v_s[2]});
  };
  if (k_first <= k_last) load_kv(k_first, 0);
  cp_async_commit();

  const int r0 = warp * 16 + lane / 4;
  const int qpos[2] = {q0 + r0 / G, q0 + (r0 + 8) / G};
  float lse2[2], dl[2];
  row_stats(a, qrows, r0, b, lse2[0], dl[0]);
  row_stats(a, qrows, r0 + 8, b, lse2[1], dl[1]);
  const int w_lo = q0 + warp * 16 / G;
  const int w_hi = min(q0 + (warp * 16 + 15) / G, a.seq_q - 1);
  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* Ow = Os + warp * 16 * LD;

  float dq[DN][4];
  zero(dq);
  int stage = 0;
  for (int k0 = k_first; k0 <= k_last; k0 += BK, stage ^= 1) {
    if (k0 + BK <= k_last) load_kv(k0 + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = KV + stage * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;
    if (!tile_empty(a, w_lo, w_hi, k0, k0 + BK - 1)) {
      float s[NN][4], dp[NN][4];
      zero(s);
      zero(dp);
      mma_abt<D, NN>(s, Qw, Ks, LD);
      mma_abt<D, NN>(dp, Ow, Vs, LD);
      const bool partial = tile_partial(a, w_lo, w_hi, k0, k0 + BK - 1);
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          float p = exp2f(s[n][e] * c2 - lse2[i]);
          if (partial && !keep(a, qpos[i], k0 + 8 * n + 2 * (lane % 4) + (e & 1))) p = 0.f;
          s[n][e] = p * (dp[n][e] - dl[i]);  // dS, unscaled
        }
      mma_pb<NN, DN>(dq, s, Ks, LD, 0);
    }
    __syncthreads();
  }

  bf16* dqp = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= a.seq_q) continue;
    const int head = h * G + (r0 + 8 * i) % G;
    bf16* row = dqp + b * a.dq_s[0] + qpos[i] * a.dq_s[1] + head * a.dq_s[2] + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(dq[n][2 * i] * a.scale, dq[n][2 * i + 1] * a.scale);
  }
}

// dK, dV.  grid (ceil(Sk / BKV), B*Hkv), NT threads.  Warp w owns keys
// 16*(w / SPLIT).. of the block's BKV and columns DC*(w % SPLIT).. of dK
// and dV; q tiles of MR rows (MR/G positions x G heads) come through a ring
// of two stages.  Up to D 80 the accumulators fit 128 registers (a few
// spill), so 4-warp blocks run four to an SM; D 128 and 256 need ~240, one
// 8-warp block an SM.  On the H100 at the training shape the first is 6.6 %
// faster than 8-warp blocks at one an SM.
template <int D>
struct DkvCfg {
  static constexpr int NW = D <= 80 ? 4 : 8, NT = NW * 32;
  static constexpr int MIN_BLOCKS = D <= 80 ? 4 : 1;
  static constexpr int SPLIT = D > 128 ? 2 : 1;  // D 256: two warps per 16 keys
  static constexpr int BKV = 16 * NW / SPLIT;
  static constexpr int MR = 32;
  static constexpr int DC = D / SPLIT;
  static constexpr int LD = D + 8;
  static constexpr size_t SMEM =
      static_cast<size_t>(2 * BKV + 4 * MR) * LD * sizeof(bf16) + 4 * MR * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::NT, DkvCfg<D>::MIN_BLOCKS)
    flash_bwd_dkv_mma_kernel(const FlashArgs a) {
  using C = DkvCfg<D>;
  constexpr int BKV = C::BKV, MR = C::MR, DC = C::DC, LD = C::LD, NN = MR / 8, DN = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;                      // [BKV][LD]
  bf16* QO = Vs + BKV * LD;                      // stage s: Q [MR][LD], then dout [MR][LD]
  float* stats = reinterpret_cast<float*>(QO + 4 * MR * LD);  // stage s: lse2 [MR], delta [MR]

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / a.n_kv_heads, h = blockIdx.y % a.n_kv_heads;
  const int G = a.group;
  const int k0 = blockIdx.x * BKV;
  const int kw = k0 + 16 * (warp / C::SPLIT);  // this warp's first key
  const int d0 = DC * (warp % C::SPLIT);
  const float c2 = a.scale * kLog2e;

  load_rows<D, C::NT>(Ks, BKV, static_cast<const bf16*>(a.k),
                      Rows{b * a.k_s[0], k0, h, 1, a.seq_k, a.k_s[1], a.k_s[2]});
  load_rows<D, C::NT>(Vs, BKV, static_cast<const bf16*>(a.v),
                      Rows{b * a.v_s[0], k0, h, 1, a.seq_k, a.v_s[1], a.v_s[2]});
  const int k_last = min(k0 + BKV, a.seq_k) - 1;
  const int q_lo = a.causal ? k0 : 0;
  int q_hi = a.seq_q - 1;
  if (a.window > 0) q_hi = min(q_hi, k_last + a.window - 1);
  const int bq = MR / G;
  const int q_first = (q_lo / bq) * bq;

  auto qtile = [&](int qs) {
    return Rows{b * a.q_s[0], qs, h * G, G, a.seq_q, a.q_s[1], a.q_s[2]};
  };
  auto load_q = [&](int qs, int stage) {
    bf16* qd = QO + stage * 2 * MR * LD;
    load_rows<D, C::NT>(qd, MR, q, qtile(qs));
    load_rows<D, C::NT>(qd + MR * LD, MR, dout,
                        Rows{b * a.do_s[0], qs, h * G, G, a.seq_q, a.do_s[1], a.do_s[2]});
  };
  if (q_first <= q_hi) {
    load_q(q_first, 0);
    if (threadIdx.x < MR) row_stats(a, qtile(q_first), threadIdx.x, b, stats[threadIdx.x],
                                    stats[MR + threadIdx.x]);
  }
  cp_async_commit();

  const bf16* Kw = Ks + (kw - k0) * LD;
  const bf16* Vw = Vs + (kw - k0) * LD;
  const int kpos[2] = {kw + lane / 4, kw + lane / 4 + 8};
  float dk[DN][4], dv[DN][4];
  zero(dk);
  zero(dv);

  int stage = 0;
  for (int qs = q_first; qs <= q_hi; qs += bq, stage ^= 1) {
    const int next = qs + bq;
    float nl = 0.f, nd = 0.f;  // the next tile's row stats, stored after this tile
    if (next <= q_hi) {
      load_q(next, stage ^ 1);
      if (threadIdx.x < MR) row_stats(a, qtile(next), threadIdx.x, b, nl, nd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = QO + stage * 2 * MR * LD;
    const bf16* Ot = Qt + MR * LD;
    const float* lse2 = stats + stage * 2 * MR;
    const float* dl = lse2 + MR;
    const int p_lo = qs, p_hi = min(qs + bq - 1, a.seq_q - 1);
    if (!tile_empty(a, p_lo, p_hi, kw, kw + 15)) {
      float st[NN][4], dpt[NN][4];  // S^T, dP^T: this warp's 16 keys x MR rows
      zero(st);
      zero(dpt);
      mma_abt<D, NN>(st, Kw, Qt, LD);
      mma_abt<D, NN>(dpt, Vw, Ot, LD);
      const bool partial = tile_partial(a, p_lo, p_hi, kw, kw + 15);
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * n + 2 * (lane % 4) + (e & 1);
          float p = exp2f(st[n][e] * c2 - lse2[r]);
          if (partial && !keep(a, qs + r / G, kpos[e / 2])) p = 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl[r]);  // dS^T, unscaled
        }
      mma_pb<NN, DN>(dv, st, Ot, LD, d0);
      mma_pb<NN, DN>(dk, dpt, Qt, LD, d0);
    }
    if (next <= q_hi && threadIdx.x < MR) {
      float* ns = stats + (stage ^ 1) * 2 * MR;
      ns[threadIdx.x] = nl;
      ns[MR + threadIdx.x] = nd;
    }
    __syncthreads();
  }

  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= a.seq_k) continue;
    bf16* krow = dkp + b * a.dk_s[0] + kpos[i] * a.dk_s[1] + h * a.dk_s[2] + d0 + 2 * (lane % 4);
    bf16* vrow = dvp + b * a.dv_s[0] + kpos[i] * a.dv_s[1] + h * a.dv_s[2] + d0 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * n) =
          __floats2bfloat162_rn(dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * n) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
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

template <int D>
int fwd(const FlashArgs& a) {
  constexpr int M = 64;
  const size_t smem = (D * M + 2 * D * (kBK + 1) + kBK * (M + 4)) * sizeof(float);
  const dim3 grid(cdiv(a.seq_q, M / a.group), a.batch * a.n_kv_heads);
  return static_cast<int>(launch(flash_fwd_kernel<D, M>, grid, M * 4, smem, a));
}

// delta for the backward of either dtype.
template <typename T, int D>
cudaError_t launch_delta(const FlashArgs& a) {
  const long long rows = static_cast<long long>(a.batch) * a.seq_q * a.n_kv_heads * a.group;
  return launch(flash_bwd_delta_kernel<T, D>, dim3(cdiv(rows, 8)), 256, 0, a);
}

template <int D>
int bwd(const FlashArgs& a) {
  // D 256 takes half tiles so that a block's fp32 tiles fit in 227 KB
  constexpr int M = D > 128 ? 32 : 64;
  constexpr int BKV = D > 128 ? 32 : 64;
  cudaError_t err = launch_delta<float, D>(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_kv =
      (2 * D * BKV + 2 * D * (kMR + 1) + 2 * kMR * (BKV + 4) + 2 * kMR) * sizeof(float);
  err = launch(flash_bwd_dkv_kernel<D, BKV>, dim3(cdiv(a.seq_k, BKV), a.batch * a.n_kv_heads),
               BKV * 4, smem_kv, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_q = (2 * D * M + 2 * D * (kBK + 1) + kBK * (M + 4) + 2 * M) * sizeof(float);
  err = launch(flash_bwd_dq_kernel<D, M>, dim3(cdiv(a.seq_q, M / a.group), a.batch * a.n_kv_heads),
               M * 4, smem_q, a);
  return static_cast<int>(err);
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// 128-row query tiles where they still give at least four blocks per SM,
// else 64 (D 256 always takes 64: its O accumulator is 128 registers a
// thread).  On the H100 the training shape (4096 blocks) is fastest with
// 128 rows, and zamba2's [4, 512, 32/32, 64] (512 blocks) with 64.
template <int D>
bool big_q_tiles(const FlashArgs& a) {
  return D <= 128 &&
         static_cast<long long>(cdiv(a.seq_q, 128 / a.group)) * a.batch * a.n_kv_heads >= 4 * num_sms();
}

template <int D, int M>
cudaError_t fwd_mma(const FlashArgs& a) {
  const dim3 grid(cdiv(a.seq_q, M / a.group), a.batch * a.n_kv_heads);
  return launch(flash_fwd_mma_kernel<D, M>, grid, M * 2, FwdCfg<D, M>::SMEM, a);
}

template <int D, int M>
cudaError_t dq_mma(const FlashArgs& a) {
  const dim3 grid(cdiv(a.seq_q, M / a.group), a.batch * a.n_kv_heads);
  return launch(flash_bwd_dq_mma_kernel<D, M>, grid, M * 2, DqCfg<D, M>::SMEM, a);
}

template <int D>
int fwd_bf16(const FlashArgs& a) {
  if constexpr (D <= 128) {
    if (big_q_tiles<D>(a)) return static_cast<int>(fwd_mma<D, 128>(a));
  }
  return static_cast<int>(fwd_mma<D, 64>(a));
}

template <int D>
int bwd_bf16(const FlashArgs& a) {
  cudaError_t err = launch_delta<bf16, D>(a);
  if (err != cudaSuccess) return static_cast<int>(err);
  using KV = DkvCfg<D>;
  err = launch(flash_bwd_dkv_mma_kernel<D>, dim3(cdiv(a.seq_k, KV::BKV), a.batch * a.n_kv_heads),
               KV::NT, KV::SMEM, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (D <= 128) {
    if (big_q_tiles<D>(a)) return static_cast<int>(dq_mma<D, 128>(a));
  }
  return static_cast<int>(dq_mma<D, 64>(a));
}

// fp32 takes the CUDA-core kernels, bf16 the tensor-core ones.
template <int D, bool BWD>
int dispatch_d(const FlashArgs& a) {
  if (a.dtype == 1) return BWD ? bwd_bf16<D>(a) : fwd_bf16<D>(a);
  return BWD ? bwd<D>(a) : fwd<D>(a);
}

template <bool BWD>
int dispatch(const FlashArgs* a) {
  if (a->dtype != 0 && a->dtype != 1) return -1;
  switch (a->head_dim) {
    case 64: return dispatch_d<64, BWD>(*a);
    case 80: return dispatch_d<80, BWD>(*a);
    case 128: return dispatch_d<128, BWD>(*a);
    case 256: return dispatch_d<256, BWD>(*a);
    default: return -1;
  }
}

}  // namespace

// Each returns cudaGetLastError() after its launches, or -1 for a shape
// this build has no instance for (the wrapper checks that first).
extern "C" int flash_attention_fwd_launch(const FlashArgs* a) { return dispatch<false>(a); }
extern "C" int flash_attention_bwd_launch(const FlashArgs* a) { return dispatch<true>(a); }
