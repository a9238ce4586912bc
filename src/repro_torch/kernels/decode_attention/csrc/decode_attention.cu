// Single-token GQA decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention_fwd` in
// src/repro/kernels/decode_attention/decode_attention.py.  Same function, with
// two differences in what it is given:
//   * each cache slot's absolute position (`pos_k [B, Sk]`), so that a
//     sliding-window ring buffer that has wrapped is masked by the positions
//     its slots hold, not by slot index;
//   * the cache in the model's layout [B, Sk, Hkv, D], read through strides,
//     so no transposed or padded copy of the cache is made per step; the
//     ragged edge (slots past Sk) is never read.
// A slot j takes part iff 0 <= pos_k[j] <= pos and pos - pos_k[j] < window.
// A row with no such slot gives 0.
//
// What bounds it: bytes, and at decode sizes the latency of reaching them.
// One query row per (batch, kv head) against Sk cache rows does 4*G*D flops
// per 4*D bytes of K and V (bf16): about G flops per byte, far below the ~295
// the H100 needs to be compute bound, so CUDA cores do the arithmetic.  A
// decode call moves 0.1-2 MB, which the card streams in microseconds; what
// costs is launches and dependent round trips to memory.  So:
//   * one launch, no scratch in device memory.  The sequence is cut into
//     n_split splits (the wrapper's `split_plan`); the n_split blocks of one
//     (batch, kv head) form a thread-block cluster.  Each block leaves its
//     (max, sum, acc[G][D]) in shared memory; after `cluster.sync()` each
//     block folds one slice of the output from all peers' partials through
//     distributed shared memory, in rank order (deterministic), and writes
//     it in the query's dtype;
//   * one block handles all G query heads of one kv head, so a K/V row is
//     read once for the whole group (the TPU grid (b, hq, k) reads it G times);
//   * two round trips, not one per slot: a block loads its split's slot
//     positions with one coalesced load, then issues 16-byte `cp.async`
//     copies of every kept K and V row of up to kStages tiles of 32 slots at
//     once (rows that the mask drops are zero-filled, not read; a tile with
//     no kept slot is not loaded or computed at all);
//   * the scores of a 32-slot tile come from shared memory: LPS lanes share a
//     K row (16 bytes each, the query chunks in registers), and the G partial
//     dot products are reduced across those lanes together, each step halving
//     the values a lane carries; one warp per query head then updates the
//     online softmax for the tile, and every thread adds p * V for one 16-byte
//     column chunk over its share of the tile's slots.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;               // cache slots a tile
constexpr int kPosCap = 1024;           // slot positions held in shared memory at once
constexpr int kStageBudget = 64 * 1024; // bytes of K and V tiles in flight (at least two tiles)
constexpr int kMaxSplit = 16;           // blocks of a cluster (non-portable above 8)
constexpr float kLog2e = 1.4426950408889634f;

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

// the 16 bytes at p (shared memory) as fp32
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&out)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_float(e[i]);
}

// 16 bytes global -> shared, bypassing L1; with full == false the 16 bytes
// are zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sums v[g] over the LPS lanes of a group (LPS a power of two, G <= LPS).  The
// first log2(G) steps halve the values each lane carries (a lane keeps one
// half and adds its partner's copy of it), the rest are a plain butterfly: 1 +
// 2 + ... + G/2 + log2(LPS/G) shuffles instead of G log2(LPS).  On return
// lane l of the group holds the sum of query head (l % LPS) / (LPS / G).
template <int G, int LPS>
__device__ __forceinline__ float reduce_group(float (&v)[G], int lane) {
#pragma unroll
  for (int o = LPS / 2, n = G; o > 0; o >>= 1) {
    if (n > 1) {
      const bool upper = lane & o;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = upper ? v[i] : v[i + n / 2];
        const float keep = upper ? v[i + n / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      n /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return v[0];
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* pos_q;
  const int* pos_k;
  void* out;
  int n_kv_heads, seq_k, split_len, window;
  float scale_log2;  // softmax scale x log2(e): the softmax runs in base 2
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, pk_sb, o_sb, o_sh;
};

// Shared memory of one block, in bytes from the start.
template <typename T, int D, int G>
struct Layout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements of a 16-byte chunk
  static constexpr int kChunks = D / kVec;                        // chunks of a row
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kTileBytes = 2 * kTile * kRowBytes;  // the K rows, then the V rows
  static constexpr int kFit = kStageBudget / kTileBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 8 ? 8 : kFit);
  static constexpr int kStage = 0;                               // kStages tiles
  static constexpr int kPart = kStage + kStages * kTileBytes;   // float [G][D]: this block's acc
  static constexpr int kP = kPart + 4 * G * D;                   // float [G][kTile]: scores, then p
  static constexpr int kM = kP + 4 * G * kTile;                  // float [G]: running max
  static constexpr int kL = kM + 4 * G;                          // float [G]: running sum
  static constexpr int kAlpha = kL + 4 * G;                      // float [G]: this tile's rescale
  static constexpr int kW = kAlpha + 4 * G;                      // float [kMaxSplit][G]: peers' weights
  static constexpr int kPeerL = kW + 4 * kMaxSplit * G;          // float [kMaxSplit][G]: peers' sums
  static constexpr int kLTot = kPeerL + 4 * kMaxSplit * G;       // float [G]: the folded sum
  static constexpr int kAny = kLTot + 4 * G;                     // int [kPosCap / kTile]: a kept slot?
  static constexpr int kList = kAny + 4 * (kPosCap / kTile);     // int [kPosCap / kTile]
  static constexpr int kNList = kList + 4 * (kPosCap / kTile);   // int
  static constexpr int kKeep = kNList + 4;                       // uchar [kPosCap]
  static constexpr int kBytes = kKeep + kPosCap;
};

// grid (n_split, B*Hkv), cluster (n_split, 1, 1), kThreads threads.  Block
// (split, b*Hkv + h) folds the slots [split*split_len, min(+split_len, Sk))
// of kv head h into one (max, sum, acc) per query head, then the cluster
// folds its blocks' partials and writes out[b, h*G + i, :].
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Params p) {
  using L = Layout<T, D, G>;
  constexpr int VEC = L::kVec;
  constexpr int CH = L::kChunks;
  constexpr int NST = L::kStages;
  constexpr int LPS = CH < 32 ? CH : 32;  // lanes that share one K row in the score step
  constexpr int KK = CH / LPS;            // chunks of a row per lane
  constexpr int SPP = kThreads / LPS;     // slots scored at once
  constexpr int TPU = kThreads / CH;      // threads that share a column chunk in p * V
  static_assert(G <= kWarps && G <= LPS, "one warp per query head in the softmax step");
  static_assert(kTile == 32 && kTile % SPP == 0 && kTile % TPU == 0, "tile shape");
  static_assert(kPosCap / kTile <= 32 && kThreads % kTile == 0, "one warp lists the tiles");
  static_assert(TPU * G * D * 4 <= NST * L::kTileBytes, "the p * V partials reuse the stage");

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stage = smem + L::kStage;
  float* s_part = reinterpret_cast<float*>(smem + L::kPart);
  float* s_p = reinterpret_cast<float*>(smem + L::kP);
  float* s_m = reinterpret_cast<float*>(smem + L::kM);
  float* s_l = reinterpret_cast<float*>(smem + L::kL);
  float* s_alpha = reinterpret_cast<float*>(smem + L::kAlpha);
  float* s_w = reinterpret_cast<float*>(smem + L::kW);
  float* s_peer_l = reinterpret_cast<float*>(smem + L::kPeerL);
  float* s_ltot = reinterpret_cast<float*>(smem + L::kLTot);
  int* s_any = reinterpret_cast<int*>(smem + L::kAny);
  int* s_list = reinterpret_cast<int*>(smem + L::kList);
  int* s_nlist = reinterpret_cast<int*>(smem + L::kNList);
  unsigned char* s_keep = smem + L::kKeep;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / p.n_kv_heads;
  const int h = bh % p.n_kv_heads;
  const int start = blockIdx.x * p.split_len;
  const int end = min(start + p.split_len, p.seq_k);
  const int pos = p.pos_q[b];

  // score step: lane `sub` of slot group `grp` holds the query chunks
  // sub + LPS*kk of every query head, pre-scaled
  const int sub = tid % LPS;
  const int grp = tid / LPS;
  float qr[G][KK][VEC];
  {
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + static_cast<long long>(h) * G * p.q_sh;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          qr[g][kk][e] = to_float(q[g * p.q_sh + (sub + kk * LPS) * VEC + e]) * p.scale_log2;
  }
  // p * V step: this thread's column chunk and its share of a tile's slots
  const int unit = tid % CH;
  const int jpart = tid / CH;
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  if (tid < G) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int* pkb = p.pos_k + b * p.pk_sb;

  // K and V rows of tile t of the window at w0 into stage buffer buf
  auto issue = [&](int w0, int wn, int t, int buf) {
    unsigned char* sk = stage + buf * L::kTileBytes;
    unsigned char* sv = sk + kTile * L::kRowBytes;
    for (int i = tid; i < kTile * CH; i += kThreads) {
      const int j = i / CH;
      const int c = i % CH;
      const int w = t * kTile + j;
      const bool keep = w < wn && s_keep[w];
      const long long slot = keep ? w0 + w : start;  // a valid address either way
      cp_async16(sk + j * L::kRowBytes + c * 16, kb + slot * p.k_ss + c * VEC, keep);
      cp_async16(sv + j * L::kRowBytes + c * 16, vb + slot * p.v_ss + c * VEC, keep);
    }
  };

  for (int w0 = start; w0 < end; w0 += kPosCap) {
    const int wn = min(kPosCap, end - w0);
    const int nt = (wn + kTile - 1) / kTile;
    __syncthreads();  // the previous window's flags are no longer read
    // a warp's 32 lanes look at the 32 slots of one tile (kTile == 32)
    for (int i = tid; i < nt * kTile; i += kThreads) {
      bool keep = false;
      if (i < wn) {
        const int pk = pkb[w0 + i];
        keep = pk >= 0 && pk <= pos && (p.window <= 0 || pos - pk < p.window);
      }
      s_keep[i] = keep;
      const unsigned any = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_any[i / kTile] = any != 0u;
    }
    __syncthreads();
    if (warp == 0) {  // the tiles that hold a kept slot, in order (nt <= 32)
      const bool any = lane < nt && s_any[lane];
      const unsigned mask = __ballot_sync(0xffffffffu, any);
      if (any) s_list[__popc(mask & ((1u << lane) - 1u))] = lane;
      if (lane == 0) *s_nlist = __popc(mask);
    }
    __syncthreads();
    const int nl = *s_nlist;

#pragma unroll
    for (int u = 0; u < NST - 1; ++u) {
      if (u < nl) issue(w0, wn, s_list[u], u);
      cp_async_commit();
    }
    for (int u = 0; u < nl; ++u) {
      const int nxt = u + NST - 1;
      if (nxt < nl) issue(w0, wn, s_list[nxt], nxt % NST);
      cp_async_commit();
      cp_async_wait<NST - 1>();  // tile u has landed
      __syncthreads();
      const int t = s_list[u];
      const unsigned char* sk = stage + (u % NST) * L::kTileBytes;
      const unsigned char* sv = sk + kTile * L::kRowBytes;

      // scores (log2 units) of the tile's slots, -inf where the mask drops one
#pragma unroll
      for (int j = grp; j < kTile; j += SPP) {
        const T* krow = reinterpret_cast<const T*>(sk + j * L::kRowBytes);
        float sc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          float kv[VEC];
          load_chunk<T, VEC>(krow + (sub + kk * LPS) * VEC, kv);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int e = 0; e < VEC; ++e) sc[g] = fmaf(qr[g][kk][e], kv[e], sc[g]);
        }
        const float tot = reduce_group<G, LPS>(sc, sub);
        if (sub % (LPS / G) == 0) {
          const int w = t * kTile + j;
          s_p[(sub / (LPS / G)) * kTile + j] = (w < wn && s_keep[w]) ? tot : -INFINITY;
        }
      }
      __syncthreads();

      // online softmax: warp g folds the tile's scores of query head g
      if (warp < G) {
        const int g = warp;
        const float s = s_p[g * kTile + lane];
        float mt = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_old = s_m[g];
        const float m_new = fmaxf(m_old, mt);  // finite: the tile holds a kept slot
        const float pr = s == -INFINITY ? 0.f : exp2f(s - m_new);
        float sum = pr;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        s_p[g * kTile + lane] = pr;
        if (lane == 0) {
          const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
          s_alpha[g] = alpha;
          s_l[g] = s_l[g] * alpha + sum;
          s_m[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p * V over this thread's slots of the tile
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float alpha = s_alpha[g];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int j = jpart; j < kTile; j += TPU) {
        float vv[VEC];
        load_chunk<T, VEC>(reinterpret_cast<const T*>(sv + j * L::kRowBytes) + unit * VEC, vv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr = s_p[g * kTile + j];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr, vv[e], acc[g][e]);
        }
      }
      __syncthreads();  // the stage buffer and s_p are free again
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's acc[G][D]: the TPU threads of a column chunk add their
  // shares, in order, through the (now idle) stage
  float* red = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[jpart * G * D + g * D + unit * VEC + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int jp = 0; jp < TPU; ++jp) a += red[jp * G * D + i];
    s_part[i] = a;
  }

  // fold the cluster's partials in rank order; every block reaches both
  // cluster barriers, the empty ones too
  cluster.sync();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (tid < n * G) {
    const int s = tid / G;
    const int g = tid % G;
    s_w[tid] = cluster.map_shared_rank(s_m, s)[g];
    s_peer_l[tid] = cluster.map_shared_rank(s_l, s)[g];
  }
  __syncthreads();
  if (tid < G) {
    const int g = tid;
    float mx = -INFINITY;
    for (int s = 0; s < n; ++s) mx = fmaxf(mx, s_w[s * G + g]);
    float l = 0.f;
    for (int s = 0; s < n; ++s) {
      const float w = mx == -INFINITY ? 0.f : exp2f(s_w[s * G + g] - mx);
      s_w[s * G + g] = w;
      l += s_peer_l[s * G + g] * w;
    }
    s_ltot[g] = l;
  }
  __syncthreads();
  const int per = (G * D + n - 1) / n;
  const int lo = rank * per;
  const int hi = min(lo + per, G * D);
  T* out = static_cast<T*>(p.out) + b * p.o_sb + static_cast<long long>(h) * G * p.o_sh;
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int g = i / D;
    float a = 0.f;
    for (int s = 0; s < n; ++s) a += cluster.map_shared_rank(s_part, s)[i] * s_w[s * G + g];
    const float l = s_ltot[g];
    out[g * p.o_sh + i % D] = from_float<T>(l > 0.f ? a / l : 0.f);
  }
  cluster.sync();  // no block leaves while a peer still reads its shared memory
}

template <typename T, int D, int G>
cudaError_t set_attributes() {
  auto kernel = decode_attention_kernel<T, D, G>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<T, D, G>::kBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T, int D, int G>
cudaLaunchConfig_t config(int n_split, int rows, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Layout<T, D, G>::kBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Request {
  Params p;
  int batch, n_split;
  cudaStream_t stream;
  int* clusters;  // non-null: report cudaOccupancyMaxActiveClusters instead of launching
  int* smem;
};

template <typename T, int D, int G>
int run(const Request& r) {
  static const cudaError_t attr_err = set_attributes<T, D, G>();  // once per instance
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  cudaLaunchAttribute attr;
  const int rows = r.clusters ? 1 : r.batch * r.p.n_kv_heads;
  cudaLaunchConfig_t cfg = config<T, D, G>(r.n_split, rows, r.stream, &attr);
  if (r.clusters) {
    *r.smem = Layout<T, D, G>::kBytes;
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(r.clusters, decode_attention_kernel<T, D, G>, &cfg));
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, D, G>, r.p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_group(const Request& r, int group) {
  switch (group) {
    case 1: return run<T, D, 1>(r);
    case 2: return run<T, D, 2>(r);
    case 4: return run<T, D, 4>(r);
    case 8: return run<T, D, 8>(r);
    default: return -1;
  }
}

template <typename T>
int dispatch_dim(const Request& r, int head_dim, int group) {
  switch (head_dim) {
    case 64: return dispatch_group<T, 64>(r, group);
    case 128: return dispatch_group<T, 128>(r, group);
    case 256: return dispatch_group<T, 256>(r, group);
    default: return -1;
  }
}

int dispatch(const Request& r, int dtype, int head_dim, int group) {
  if (r.n_split < 1 || r.n_split > kMaxSplit) return -1;
  switch (dtype) {
    case 0: return dispatch_dim<float>(r, head_dim, group);
    case 1: return dispatch_dim<__nv_bfloat16>(r, head_dim, group);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  One launch of
// grid (n_split, batch * n_kv_heads) in clusters of n_split blocks, each
// block folding split_len slots.  Returns cudaGetLastError() after the
// launch, or -1 for a shape this build has no instance for (the wrapper
// checks that first).
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, const void* pos_q,
    const void* pos_k, void* out, int batch, int n_kv_heads, int group, int head_dim,
    int seq_k, int split_len, int n_split, int window, float scale, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long pk_sb, long long o_sb, long long o_sh,
    void* stream) {
  Request r = {};
  r.p.q = q;
  r.p.k = k;
  r.p.v = v;
  r.p.pos_q = static_cast<const int*>(pos_q);
  r.p.pos_k = static_cast<const int*>(pos_k);
  r.p.out = out;
  r.p.n_kv_heads = n_kv_heads;
  r.p.seq_k = seq_k;
  r.p.split_len = split_len;
  r.p.window = window;
  r.p.scale_log2 = scale * kLog2e;
  r.p.q_sb = q_sb;
  r.p.q_sh = q_sh;
  r.p.k_sb = k_sb;
  r.p.k_ss = k_ss;
  r.p.k_sh = k_sh;
  r.p.v_sb = v_sb;
  r.p.v_ss = v_ss;
  r.p.v_sh = v_sh;
  r.p.pk_sb = pk_sb;
  r.p.o_sb = o_sb;
  r.p.o_sh = o_sh;
  r.batch = batch;
  r.n_split = n_split;
  r.stream = static_cast<cudaStream_t>(stream);
  return dispatch(r, dtype, head_dim, group);
}

// How many clusters of n_split blocks of the (dtype, head_dim, group)
// instance the card can hold at once (cudaOccupancyMaxActiveClusters), and
// the dynamic shared memory of one block.  Returns a cudaError_t, or -1 for
// a shape this build has no instance for.
extern "C" int decode_attention_occupancy(int dtype, int head_dim, int group, int n_split,
                                          int* clusters, int* smem_bytes) {
  Request r = {};
  r.n_split = n_split;
  r.clusters = clusters;
  r.smem = smem_bytes;
  return dispatch(r, dtype, head_dim, group);
}
