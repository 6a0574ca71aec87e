// Definitions shared by the attention kernels for Hopper (sm_90a), the
// forward (attention_fwd.cuh), the backward (attention_bwd.cu) and the
// window-kernel probes (probe_window.cu), and by K5's first pass
// (gemm_int8.cu): ldmatrix fragment loads and the m16n8k16 bf16 mma.sync
// with fp32 accumulation.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                           a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same)
//   B (16 x 8):             b0 (k rows 2t, 2t+1, col g), b1 (k rows 2t+8, 2t+9)
//   C (16 x 8, fp32):       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace sam3 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Where an (n, p, l, dh) operand keeps its elements: the strides, in elements,
// of sequence n, head p and row l; the dh elements of a row are contiguous.
// Packed (N, L, P*DH) operands have p = DH; head-major (B, H, L, D) ones any.
struct Strides {
  long long n, p, l;
  __device__ __forceinline__ long long at(long long ni, int pi) const {
    return ni * n + pi * p;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of the 16 x 16 block at `base` of a row-major [m][k] tile.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* base, int ld) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, base + (lane & 15) * ld + (lane >> 4) * 8);
}

// B fragments of two adjacent n8 tiles (r[0], r[1] and r[2], r[3]) over one
// k16 step, from a tile stored [n][k] (`base` at n0, k0).
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const bf16* base, int ld) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, base + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8);
}

// d += a * b for one m16n8k16 tile, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace sam3
