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
//
// What bounds it: bytes.  One query row per (batch, kv head) against Sk cache
// rows does 4*G*D flops per 4*D bytes of K and V (bf16) -- about G flops per
// byte, far below the ~295 the H100 needs to be compute bound.  So the design
// aims at reading each K/V byte once and keeping enough loads in flight:
//   * one block handles all G query heads of one kv head, so a K/V row is
//     read once for the whole group (the TPU grid (b, hq, k) reads it G times);
//   * the sequence is split across blocks (grid.x) so that a decode batch of
//     4-8 rows still puts tens of blocks on the 132 SMs; inside a block each
//     warp runs its own online softmax over every kWarps-th key, with K and V
//     rows loaded as 16-byte vectors (one row per warp instruction);
//   * slots that the mask rejects are skipped before their K/V is loaded;
//   * a second small kernel merges the per-split (max, sum, acc) partials,
//     all in fp32, and writes the output in the query's dtype.
// No tensor cores, TMA or cp.async yet: this is the first, simple version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMergeThreads = 256;

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

template <int BYTES>
struct Chunk;
template <>
struct Chunk<4> { using type = unsigned int; };
template <>
struct Chunk<8> { using type = uint2; };
template <>
struct Chunk<16> { using type = uint4; };

// VEC contiguous elements at p, as fp32.  p is aligned to min(16, VEC*sizeof(T))
// bytes (the wrapper checks base pointers and strides).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  constexpr int kChunk = kBytes >= 16 ? 16 : kBytes;
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
  using C = typename Chunk<kChunk>::type;
  const C* src = reinterpret_cast<const C*>(p);
#pragma unroll
  for (int c = 0; c < kBytes / kChunk; ++c) {
    C raw = __ldg(src + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[c * kPer + j] = to_float(e[j]);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos_q;
  const int* pos_k;
  void* out;
  float* part_acc;  // [B*Hkv, n_split, G, D]
  float* part_ml;   // [B*Hkv, n_split, G, 2]: running max, running sum
  int batch, n_kv_heads, group, head_dim, seq_k, split_len, n_split, window;
  float scale;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, pk_sb, o_sb, o_sh;
  cudaStream_t stream;
};

// grid (n_split, B*Hkv), kThreads threads.  Block (split, b*Hkv+h) folds the
// keys [split*split_len, min(+split_len, Sk)) into one (max, sum, acc) per
// query head of kv head h.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos_q, const int* __restrict__ pos_k,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int n_kv_heads,
    int seq_k, int split_len, int window, float scale, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long pk_sb) {
  constexpr int VEC = D / 32;
  const int bh = blockIdx.y;
  const int b = bh / n_kv_heads;
  const int h = bh % n_kv_heads;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // this lane's VEC elements of each query head, pre-scaled
  float qr[G][VEC];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    load_vec<T, VEC>(q + b * q_sb + static_cast<long long>(h * G + i) * q_sh + lane * VEC, qr[i]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[i][e] *= scale;
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  }

  const int pos = pos_q[b];
  const int start = split * split_len;
  const int end = min(start + split_len, seq_k);
  const T* kb = k + b * k_sb + h * k_sh + lane * VEC;
  const T* vb = v + b * v_sb + h * v_sh + lane * VEC;
  const int* pkb = pos_k + b * pk_sb;
  for (int j = start + warp; j < end; j += kWarps) {
    const int pk = pkb[j];
    const int dp = pos - pk;
    // warp-uniform: every lane of the warp looks at the same slot j
    if (pk < 0 || dp < 0 || (window > 0 && dp >= window)) continue;
    float kr[VEC], vr[VEC];
    load_vec<T, VEC>(kb + j * k_ss, kr);
    load_vec<T, VEC>(vb + j * v_ss, vr);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s = fmaf(qr[i][e], kr[e], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float m_new = fmaxf(m[i], s);
      const float alpha = __expf(m[i] - m_new);  // 0 while m[i] is -inf
      const float p = __expf(s - m_new);
      l[i] = l[i] * alpha + p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(p, vr[e], acc[i][e] * alpha);
      m[i] = m_new;
    }
  }

  // merge the kWarps per-warp states of this block
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][D];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (lane == 0) {
      s_m[warp][i] = m[i];
      s_l[warp][i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_acc[warp][i][lane * VEC + e] = acc[i][e];
  }
  __syncthreads();

  const long long part = static_cast<long long>(bh) * n_split + split;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][i]);
    float a = 0.f;
    if (mx > -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += s_acc[w][i][d] * __expf(s_m[w][i] - mx);
    }
    part_acc[part * G * D + idx] = a;
  }
  if (threadIdx.x < G) {
    const int i = threadIdx.x;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][i]);
    float sum = 0.f;
    if (mx > -INFINITY) {
      for (int w = 0; w < kWarps; ++w) sum += s_l[w][i] * __expf(s_m[w][i] - mx);
    }
    part_ml[(part * G + i) * 2] = mx;
    part_ml[(part * G + i) * 2 + 1] = sum;
  }
}

// grid (B*Hkv), kMergeThreads threads: folds the n_split partials of each
// query head and writes out[b, h*G+i, :] = acc / sum in T.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) decode_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int n_kv_heads, int group, int head_dim, int n_split,
    long long o_sb, long long o_sh) {
  const int bh = blockIdx.x;
  const int b = bh / n_kv_heads;
  const int h = bh % n_kv_heads;
  const float* ml = part_ml + static_cast<long long>(bh) * n_split * group * 2;
  const float* acc = part_acc + static_cast<long long>(bh) * n_split * group * head_dim;
  for (int idx = threadIdx.x; idx < group * head_dim; idx += kMergeThreads) {
    const int i = idx / head_dim;
    const int d = idx % head_dim;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[(s * group + i) * 2]);
    float a = 0.f, sum = 0.f;
    if (mx > -INFINITY) {
      for (int s = 0; s < n_split; ++s) {
        const float w = __expf(ml[(s * group + i) * 2] - mx);
        sum += ml[(s * group + i) * 2 + 1] * w;
        a += acc[(static_cast<long long>(s) * group + i) * head_dim + d] * w;
      }
    }
    out[b * o_sb + static_cast<long long>(h * group + i) * o_sh + d] =
        from_float<T>(a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const Args& a) {
  const dim3 grid(a.n_split, a.batch * a.n_kv_heads);
  decode_partial_kernel<T, D, G><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.pos_q, a.pos_k, a.part_acc, a.part_ml, a.n_kv_heads, a.seq_k, a.split_len,
      a.window, a.scale, a.q_sb, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.pk_sb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T><<<a.batch * a.n_kv_heads, kMergeThreads, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), a.n_kv_heads, G, D, a.n_split,
      a.o_sb, a.o_sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_group(const Args& a) {
  switch (a.group) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 4: return launch<T, D, 4>(a);
    case 8: return launch<T, D, 8>(a);
    default: return -1;
  }
}

template <typename T>
int dispatch_dim(const Args& a) {
  switch (a.head_dim) {
    case 64: return dispatch_group<T, 64>(a);
    case 128: return dispatch_group<T, 128>(a);
    case 256: return dispatch_group<T, 256>(a);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns
// cudaGetLastError() after the launches, or -1 for a shape this build has no
// instance for (the wrapper checks that first).
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, const void* pos_q,
    const void* pos_k, void* out, void* part_acc, void* part_ml, int batch,
    int n_kv_heads, int group, int head_dim, int seq_k, int split_len, int n_split,
    int window, float scale, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long pk_sb, long long o_sb, long long o_sh, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos_q = static_cast<const int*>(pos_q);
  a.pos_k = static_cast<const int*>(pos_k);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.batch = batch;
  a.n_kv_heads = n_kv_heads;
  a.group = group;
  a.head_dim = head_dim;
  a.seq_k = seq_k;
  a.split_len = split_len;
  a.n_split = n_split;
  a.window = window;
  a.scale = scale;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.pk_sb = pk_sb;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dim<float>(a);
    case 1: return dispatch_dim<__nv_bfloat16>(a);
    default: return -1;
  }
}
