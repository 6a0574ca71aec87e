// Building blocks shared by the packed attention forward (attention_fwd.cu)
// and backward (attention_bwd.cu) kernels for Hopper (sm_90a): 64-row tiles
// in shared memory with a padded row stride, ldmatrix fragment loads and the
// m16n8k16 bf16 mma.sync with fp32 accumulation.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                           a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same)
//   B (16 x 8):             b0 (k rows 2t, 2t+1, col g), b1 (k rows 2t+8, 2t+9)
//   C (16 x 8, fp32):       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// So the accumulators of two adjacent n8 tiles, packed to bf16, are the A
// fragment of one k16 step: scores turn into the A operand of the next
// product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace sam3 {

constexpr int BQ = 64;  // query rows per tile, 16 per warp
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
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

template <int DH>
struct Layout {
  static constexpr int LDH = DH + 8;  // bf16 row stride: conflict-free ldmatrix
  static constexpr size_t tile = size_t(64) * LDH;  // elements per 64-row tile
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// The same from a tile stored [k][n] (`base` at k0, n0), transposed on load.
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const bf16* base, int ld) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(r, base + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
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

// Copy `rows_valid` rows of DH bf16 into a 64-row shared tile (rows past the
// end are zero). With ROPE, each thread carries a chunk of the first half of
// a row and the matching chunk of the second half, and rotates them in
// registers: x[:h], x[h:] -> x[:h]*cos - x[h:]*sin, x[:h]*sin + x[h:]*cos,
// with the tables at sequence position row0 + r.
template <int DH, bool ROPE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld,
                                          int rows_valid, const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, int row0) {
  constexpr int LDH = Layout<DH>::LDH;
  if (!ROPE) {
    constexpr int CPR = DH / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < 64 * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
      *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
    }
    return;
  }
  constexpr int H = DH / 2;
  constexpr int CPH = H / 8;  // chunks per half row
  for (int i = threadIdx.x; i < 64 * CPH; i += THREADS) {
    const int r = i / CPH, c = (i % CPH) * 8;
    uint4 ve = make_uint4(0u, 0u, 0u, 0u), vo = ve;
    if (r < rows_valid) {
      ve = *reinterpret_cast<const uint4*>(src + r * ld + c);
      vo = *reinterpret_cast<const uint4*>(src + r * ld + c + H);
      const float* cs = cos_t + (long long)(row0 + r) * H + c;
      const float* sn = sin_t + (long long)(row0 + r) * H + c;
      const float4 c0 = *reinterpret_cast<const float4*>(cs);
      const float4 c1 = *reinterpret_cast<const float4*>(cs + 4);
      const float4 s0 = *reinterpret_cast<const float4*>(sn);
      const float4 s1 = *reinterpret_cast<const float4*>(sn + 4);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const bf16* pe = reinterpret_cast<const bf16*>(&ve);
      const bf16* po = reinterpret_cast<const bf16*>(&vo);
      uint4 re, ro;
      uint32_t* qe = reinterpret_cast<uint32_t*>(&re);
      uint32_t* qo = reinterpret_cast<uint32_t*>(&ro);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float e0 = __bfloat162float(pe[j]), e1 = __bfloat162float(pe[j + 1]);
        const float o0 = __bfloat162float(po[j]), o1 = __bfloat162float(po[j + 1]);
        qe[j / 2] = pack_bf16(e0 * cv[j] - o0 * sv[j], e1 * cv[j + 1] - o1 * sv[j + 1]);
        qo[j / 2] = pack_bf16(e0 * sv[j] + o0 * cv[j], e1 * sv[j + 1] + o1 * cv[j + 1]);
      }
      ve = re;
      vo = ro;
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = ve;
    *reinterpret_cast<uint4*>(dst + r * LDH + c + H) = vo;
  }
}

}  // namespace sam3
