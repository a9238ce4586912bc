// C1: the Mamba2 mixer's depthwise causal conv, its bias and SiLU, both
// ways, for Hopper (sm_90a), CUDA C++.
//
// Replaces no Pallas call.  The JAX package computes this in jnp
// (src/repro/models/mamba2.py `_causal_conv`, then `jax.nn.silu`), and the
// port first did the same in PyTorch: per tap a slice of the padded input,
// a cast to fp32, a broadcast multiply and an add into an fp32 running sum,
// then the bias and a separate SiLU, with fp32 copies of every tap kept for
// the backward.  That chain moved about 25 times the bytes the function
// needs.  The function, per (batch row, position t, channel c), W <= 4:
//   a[t]  = sum_i w[i] x[t - W + 1 + i] + b      (x = 0 before position 0)
//   y[t]  = a[t] / (1 + exp(-a[t]))               (SiLU, fp32 out)
// and its gradient, for dy = dL/dy (fp32):
//   da[t] = dy[t] s (1 + a (1 - s)),  s = 1 / (1 + exp(-a[t]))
//   dx[t] = sum_i w[i] da[t + W - 1 - i]           (da = 0 from position S)
//   dw[i] = sum_{row, t} da[t] x[t - W + 1 + i],   db = sum_{row, t} da[t].
// Each row is convolved whole: positions of packed documents are not
// separated, as in the JAX package.
//
// What bounds it: bytes.  The forward reads x and writes y in fp32, the
// backward reads x and dy and writes dx in x's dtype: about 0.24 and 0.32 ms
// at the zamba2 cell's x conv [8, 4096, 4096] in bf16.  Every tap needs a
// handful of flops an element, the SiLU an exp and a divide, so the issue
// rate comes close to the memory's; the design moves each element once and
// keeps many loads in flight:
//   * a thread owns 4 consecutive channels of one row and walks a tile of
//     positions in order, keeping the last W - 1 inputs in registers: each
//     input is read once, plus W - 1 halo positions a tile.  Neighbouring
//     threads own neighbouring channels, so a warp's loads are vector loads
//     of one contiguous span (bf16 kept packed until used); where channels,
//     strides or pointers are not aligned the same code loads element by
//     element (`VEC` false).  Each step a thread issues the loads of its
//     next positions before it computes the current ones (two register
//     buffers);
//   * 4 channels a thread (not 8, which takes 16-byte bf16 loads) keep the
//     registers low enough for 6 forward blocks an SM: at 8 channels and 3
//     blocks the forward took 0.36 ms, at 4 and 6 blocks 0.30 (H100);
//   * a block is 128 threads: `tx` channel groups by 128 / tx tiles of
//     positions of one row, tx = 32 where there are that many channel
//     groups, fewer on narrow rows (the B/C conv's 128 channels);
//   * the taps are summed in fp32 from 0 in tap order, then the bias, each
//     product and sum rounded on its own (no fused multiply-add): the plain
//     version's arithmetic (`ref.py`), tap for tap, and the backward's
//     recompute is the same; the SiLU takes the fast exp and divide (within
//     a few fp32 ulps; their exact forms cost 10 % of the forward's time);
//   * the backward recomputes a from x: the forward saves nothing but its
//     inputs.  One pass walks each tile backwards, carrying W - 1 values of
//     da ahead of the current position (the first W - 1 past the tile's end
//     are recomputed from the next tile's inputs), writes dx rounded once
//     from its fp32 sum, and sums each thread's share of dw and db in
//     registers (fused multiply-adds).  The block folds its threads' shares
//     in shared memory in a fixed order into one fp32 partial a block, and a
//     second small kernel adds the partials in a fixed order into w's and
//     b's dtype: no atomics, so the gradients are the same bits on every
//     run.
// The wrapper allocates the outputs and the partials' scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by ctypes in ops.py.  Strides are in elements;
// the channel dim of x and dy is contiguous, w's too.  y and dx are
// contiguous [batch, seq, channels], dw [width, channels], db [channels];
// partial is [width + 1, parts, channels] fp32, parts = batch x blocks a
// row.  `vec`: x, dy and their strides are 16-byte aligned and the channel
// count a multiple of 4.
struct ConvArgs {
  int dtype;  // of x, w, b, dx, dw and db: 0 = float32, 1 = bfloat16
  int batch, seq, channels, width, tile, tx, vec;
  const void* x;
  const void* w;
  const void* b;
  const float* dy;
  float* y;
  void* dx;
  float* partial;
  void* dw;
  void* db;
  long long x_s[2], dy_s[2];  // (batch, seq)
  long long w_s;              // w's tap stride
  void* stream;
};

namespace {

constexpr int kThreads = 128;
constexpr int kC = 4;  // channels a thread
// blocks an SM, by registers: the forward on packed bf16 rows holds few
// enough for 6; on fp32 or element-by-element rows it holds more (at 6 it
// spills); the backward holds about twice the forward's a channel (the
// look-ahead of da, dw and db)
constexpr int kFwdBlocksPacked = 6, kFwdBlocks = 4, kBwdBlocks = 4;
// positions a thread loads a step, forward and backward
constexpr int kFwdAhead = 4, kBwdAhead = 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// the 4 channels of one position as one thread loads them: aligned fp32 as a
// float4, aligned bf16 as two packed words, anything else element by element
// (n of the 4 channels exist: 4 unless at a ragged row's end)
template <typename T, bool VEC>
struct Chunk {
  float v[kC];
  __device__ __forceinline__ void load(const T* __restrict__ p, int n) {
    if constexpr (VEC) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < kC; ++j) v[j] = j < n ? to_f(p[j]) : 0.f;
    }
  }
  __device__ __forceinline__ float get(int j) const { return v[j]; }
};

template <>
struct Chunk<__nv_bfloat16, true> {
  uint2 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p, int) {
    w = *reinterpret_cast<const uint2*>(p);
  }
  // a bf16 is the upper half of the fp32 of the same value
  __device__ __forceinline__ float get(int j) const {
    const uint32_t word = j < 2 ? w.x : w.y;
    return __uint_as_float(j & 1 ? word & 0xffff0000u : word << 16);
  }
};

template <typename T, bool VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, int n, float (&v)[kC]) {
  Chunk<T, VEC> c;
  c.load(p, n);
#pragma unroll
  for (int j = 0; j < kC; ++j) v[j] = c.get(j);
}

template <bool VEC>
__device__ __forceinline__ void store(float* __restrict__ p, int n, const float (&v)[kC]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if (j < n) p[j] = v[j];
  }
}

template <bool VEC>
__device__ __forceinline__ void store(__nv_bfloat16* __restrict__ p, int n,
                                      const float (&v)[kC]) {
  if constexpr (VEC) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
  } else {
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if (j < n) p[j] = __float2bfloat16_rn(v[j]);
  }
}

__device__ __forceinline__ void zero(float (&v)[kC]) {
#pragma unroll
  for (int j = 0; j < kC; ++j) v[j] = 0.f;
}

// The pre-activation of one channel: the taps from 0 in order, then the bias,
// each product and sum rounded on its own; xw[i] is x[t - W + 1 + i].  The
// forward and the backward's recompute share it.
template <int W>
__device__ __forceinline__ float preact(const float (&w)[W][kC], float bias, int j,
                                        const float (&xw)[W][kC]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) acc = __fadd_rn(acc, __fmul_rn(xw[i][j], w[i][j]));
  return __fadd_rn(acc, bias);
}

// A thread's place: its channels from c0 (n of them exist) of row `row`, its
// tile [t0, t1); false where it has none.
struct Place {
  int row, c0, n, t0, t1;
};

__device__ __forceinline__ bool place(const ConvArgs& a, Place& p) {
  const int groups = (a.channels + kC - 1) / kC;
  const int ty = kThreads / a.tx;
  const int cg = blockIdx.x * a.tx + threadIdx.x % a.tx;
  const int tile = blockIdx.y * ty + threadIdx.x / a.tx;
  p.row = blockIdx.z;
  p.c0 = cg * kC;
  p.n = min(kC, a.channels - p.c0);
  p.t0 = tile * a.tile;
  p.t1 = min(p.t0 + a.tile, a.seq);
  return cg < groups && p.t0 < a.seq;
}

template <typename T, int W>
__device__ __forceinline__ void load_weights(const ConvArgs& a, const Place& p,
                                             float (&w)[W][kC], float (&bias)[kC]) {
#pragma unroll
  for (int i = 0; i < W; ++i)
    load<T, false>(static_cast<const T*>(a.w) + i * a.w_s + p.c0, p.n, w[i]);
  load<T, false>(static_cast<const T*>(a.b) + p.c0, p.n, bias);
}

template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 2 && VEC ? kFwdBlocksPacked : kFwdBlocks)
    causal_conv_fwd_kernel(const ConvArgs a) {
  constexpr int A = kFwdAhead;
  Place p;
  if (!place(a, p)) return;
  const T* x = static_cast<const T*>(a.x) + p.row * a.x_s[0] + p.c0;
  float* y = a.y + (static_cast<long long>(p.row) * a.seq) * a.channels + p.c0;
  float w[W][kC], bias[kC];
  load_weights<T, W>(a, p, w, bias);
  float xw[W][kC];  // x[t - W + 1 + i]; xw[W - 1] is set at t
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const int t = p.t0 - (W - 1) + i;
    if (t >= 0) load<T, VEC>(x + t * a.x_s[1], p.n, xw[i]);
    else zero(xw[i]);
  }
  Chunk<T, VEC> cur[A], nxt[A];
#pragma unroll
  for (int u = 0; u < A; ++u)
    if (p.t0 + u < p.t1) cur[u].load(x + (p.t0 + u) * a.x_s[1], p.n);
  for (int t = p.t0; t < p.t1; t += A) {
#pragma unroll
    for (int u = 0; u < A; ++u)
      if (t + A + u < p.t1) nxt[u].load(x + (t + A + u) * a.x_s[1], p.n);
#pragma unroll
    for (int u = 0; u < A; ++u) {
      if (t + u < p.t1) {
#pragma unroll
        for (int j = 0; j < kC; ++j) xw[W - 1][j] = cur[u].get(j);
        float out[kC];
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const float v = preact<W>(w, bias[j], j, xw);
          out[j] = __fdividef(v, 1.f + __expf(-v));
        }
        store<VEC>(y + static_cast<long long>(t + u) * a.channels, p.n, out);
#pragma unroll
        for (int i = 0; i < W - 1; ++i)
#pragma unroll
          for (int j = 0; j < kC; ++j) xw[i][j] = xw[i + 1][j];
      }
    }
#pragma unroll
    for (int u = 0; u < A; ++u) cur[u] = nxt[u];
  }
}

template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(kThreads, kBwdBlocks) causal_conv_bwd_kernel(const ConvArgs a) {
  constexpr int A = kBwdAhead;
  // each thread's dw (W rows) and db (one row) of its channels
  __shared__ float fold[(W + 1) * kThreads * kC];
  float dw[W + 1][kC];  // dw[W] is db
#pragma unroll
  for (int i = 0; i <= W; ++i) zero(dw[i]);
  Place p;
  if (place(a, p)) {
    const T* x = static_cast<const T*>(a.x) + p.row * a.x_s[0] + p.c0;
    const float* dy = a.dy + p.row * a.dy_s[0] + p.c0;
    T* dx = static_cast<T*>(a.dx) + (static_cast<long long>(p.row) * a.seq) * a.channels + p.c0;
    float w[W][kC], bias[kC];
    load_weights<T, W>(a, p, w, bias);
    // from the last position whose da a dx of the tile needs, down to t0
    const int hi = min(p.t1 + W - 2, a.seq - 1);
    float xw[W][kC];         // x[t - W + 1 + i] at the current t
    float ahead[W - 1][kC];  // da[t + 1 + k]: 0 past the row's end
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int t = hi - (W - 1) + i;
      if (t >= 0) load<T, VEC>(x + t * a.x_s[1], p.n, xw[i]);
      else zero(xw[i]);
    }
#pragma unroll
    for (int k = 0; k < W - 1; ++k) zero(ahead[k]);
    // dy[t - u] and x[t - u - W] of this step and of the next
    Chunk<float, VEC> g[A], g_nxt[A];
    Chunk<T, VEC> xn[A], xn_nxt[A];
    auto fetch = [&](int t, Chunk<float, VEC>(&gd)[A], Chunk<T, VEC>(&xd)[A]) {
#pragma unroll
      for (int u = 0; u < A; ++u) {
        const int s = t - u;
        if (s >= p.t0) {
          gd[u].load(dy + s * a.dy_s[1], p.n);
          if (s - W >= 0) xd[u].load(x + (s - W) * a.x_s[1], p.n);
        }
      }
    };
    fetch(hi, g, xn);
    for (int t = hi; t >= p.t0; t -= A) {
      fetch(t - A, g_nxt, xn_nxt);
#pragma unroll
      for (int u = 0; u < A; ++u) {
        const int s = t - u;
        if (s >= p.t0) {
          float da[kC];
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            const float v = preact<W>(w, bias[j], j, xw);
            const float sg = __fdividef(1.f, 1.f + __expf(-v));
            da[j] = g[u].get(j) * (sg * (1.f + v * (1.f - sg)));
          }
          if (s < p.t1) {
            float out[kC];
#pragma unroll
            for (int j = 0; j < kC; ++j) {
              float acc = 0.f;
#pragma unroll
              for (int i = 0; i < W; ++i)
                acc = fmaf(w[i][j], i == W - 1 ? da[j] : ahead[W - 2 - i][j], acc);
              out[j] = acc;
#pragma unroll
              for (int i = 0; i < W; ++i) dw[i][j] = fmaf(da[j], xw[i][j], dw[i][j]);
              dw[W][j] += da[j];
            }
            store<VEC>(dx + static_cast<long long>(s) * a.channels, p.n, out);
          }
#pragma unroll
          for (int k = W - 2; k > 0; --k)
#pragma unroll
            for (int j = 0; j < kC; ++j) ahead[k][j] = ahead[k - 1][j];
#pragma unroll
          for (int j = 0; j < kC; ++j) ahead[0][j] = da[j];
#pragma unroll
          for (int i = W - 1; i > 0; --i)
#pragma unroll
            for (int j = 0; j < kC; ++j) xw[i][j] = xw[i - 1][j];
#pragma unroll
          for (int j = 0; j < kC; ++j) xw[0][j] = s - W >= 0 ? xn[u].get(j) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < A; ++u) {
        g[u] = g_nxt[u];
        xn[u] = xn_nxt[u];
      }
    }
  }
  // the block's partial: its tiles' shares added in tile order, per channel
  const int tx = a.tx, ty = kThreads / tx;
  const int me_tx = threadIdx.x % tx, me_ty = threadIdx.x / tx;
#pragma unroll
  for (int k = 0; k <= W; ++k)
#pragma unroll
    for (int j = 0; j < kC; ++j) fold[((k * ty + me_ty) * tx + me_tx) * kC + j] = dw[k][j];
  __syncthreads();
  const int width = tx * kC;  // channels of the block
  const long long parts = static_cast<long long>(a.batch) * gridDim.y;
  const long long part = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  for (int e = threadIdx.x; e < (W + 1) * width; e += kThreads) {
    const int k = e / width, r = e % width;
    const int c = blockIdx.x * width + r;
    float s = 0.f;
    for (int q = 0; q < ty; ++q) s += fold[(k * ty + q) * width + r];
    if (c < a.channels) a.partial[(k * parts + part) * a.channels + c] = s;
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dw and db: the partials of every block added in order, one thread per
// (row of [dw; db], channel)
template <typename T>
__global__ void __launch_bounds__(kThreads) causal_conv_fold_kernel(const ConvArgs a, int parts) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(a.width + 1) * a.channels) return;
  const int k = static_cast<int>(e / a.channels), c = static_cast<int>(e % a.channels);
  const float* src = a.partial + static_cast<long long>(k) * parts * a.channels + c;
  float s = 0.f;
#pragma unroll 8
  for (int q = 0; q < parts; ++q) s += src[static_cast<long long>(q) * a.channels];
  T* out = k < a.width ? static_cast<T*>(a.dw) + k * a.channels : static_cast<T*>(a.db);
  out[c] = from_f<T>(s);
}

template <typename T, int W, bool VEC>
int launch(const ConvArgs* a, int backward) {
  const int groups = (a->channels + kC - 1) / kC;
  const int ty = kThreads / a->tx;
  const int tiles = (a->seq + a->tile - 1) / a->tile;
  const dim3 grid((groups + a->tx - 1) / a->tx, (tiles + ty - 1) / ty, a->batch);
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  if (!backward) {
    causal_conv_fwd_kernel<T, W, VEC><<<grid, kThreads, 0, st>>>(*a);
    return static_cast<int>(cudaGetLastError());
  }
  causal_conv_bwd_kernel<T, W, VEC><<<grid, kThreads, 0, st>>>(*a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const int parts = a->batch * static_cast<int>(grid.y);
  const long long n = static_cast<long long>(W + 1) * a->channels;
  causal_conv_fold_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                               st>>>(*a, parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int dispatch_vec(const ConvArgs* a, int backward) {
  return a->vec ? launch<T, W, true>(a, backward) : launch<T, W, false>(a, backward);
}

template <typename T>
int dispatch_width(const ConvArgs* a, int backward) {
  switch (a->width) {
    case 2: return dispatch_vec<T, 2>(a, backward);
    case 3: return dispatch_vec<T, 3>(a, backward);
    case 4: return dispatch_vec<T, 4>(a, backward);
    default: return -1;
  }
}

}  // namespace

// backward = 0: y from x, w, b; 1: dx, dw, db from x, w, b and dy.
extern "C" int causal_conv_launch(const ConvArgs* a, int backward) {
  if (a->batch <= 0 || a->seq <= 0 || a->channels <= 0 || a->tile <= 0 || a->tx <= 0 ||
      kThreads % a->tx || (a->vec && a->channels % kC))
    return -1;
  switch (a->dtype) {
    case 0: return dispatch_width<float>(a, backward);
    case 1: return dispatch_width<__nv_bfloat16>(a, backward);
    default: return -1;
  }
}
