// 3xTF32 products on the tensor cores (mma.sync m16n8k8), shared by the SSD
// chunk scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// x = hi + lo: hi is x rounded to TF32 (10 bits of mantissa, to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds a finite x) by two integer
// operations; lo = x - hi is exact in fp32, and the tensor core reads its
// top 11 significant bits, so hi + lo holds x to 2^-21.  (cvt.rna compiles
// to some ten instructions here, which made the splits most of the work.)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16x8 fp32) += a (16x8 tf32, row) * b (8x8 tf32, col).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of an m16n8k8 product, lane = 4 gq + tq: A holds (row, k) =
// (gq, tq), (gq + 8, tq), (gq, tq + 4), (gq + 8, tq + 4); B (k, col) =
// (tq, gq), (tq + 4, gq); the accumulator (gq, 2tq), (gq, 2tq + 1),
// (gq + 8, 2tq), (gq + 8, 2tq + 1).
struct Frag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

struct BFrag {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ BFrag(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

// d += a b in 3xTF32; the small products first, lo * lo dropped.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, const BFrag& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// The same, summed from zero and then added to d in fp32.  The tensor core
// truncates as it accumulates, so a chain of mma3 into d drifts by up to an
// ulp of d a step, always towards zero; rounding each k-step's sum into d
// to nearest holds d as an fp32 sum would.  C B^T takes this form: it
// scales every term of y, and at a chunk's first position it is all of it.
__device__ __forceinline__ void mma3_rounded(float (&d)[4], const Frag& a, const BFrag& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, a, b);
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}
