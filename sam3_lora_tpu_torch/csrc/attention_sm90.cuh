// What the attention forward (attention_fwd.cuh) and backward
// (attention_bwd.cu) share on Hopper (sm_90a): 64-row bf16 tiles as TMA
// lays them in shared memory, their wgmma descriptors in both majors, the
// m64n64 (shared-memory A and B) and m64nDH (register A) wgmma products, the
// 4-D TMA load of one 64-row box of an (N, P, L, dh) view and the host-side
// encoding of its map, and the rotate-half RoPE of one sequence row.
//
// The wgmma m64nN fp32 accumulator gives thread (warp w, lane = 4g + t) of
// the warpgroup d[4j + 2r + e] at row 16w + g + 8r, column 8j + 2t + e: the
// C fragment of mma.sync m16n8k16, n8 tile by n8 tile. So the
// accumulators of an m64n16 slice, packed to bf16 pairs, are the register A
// fragment of one k16 step (a[0], a[1]: rows g and g + 8 of columns 2t..;
// a[2], a[3]: the same eight columns on).

#pragma once

#include "attention_common.cuh"
#include "sm90.cuh"

namespace sam3 {

constexpr int TILE = 64;  // rows of a tile: one warpgroup's m64, one TMA box

// One 64-row tile of an (L, DH) bf16 operand as TMA lays it in shared
// memory: rows of DH * 2 bytes (128: SWIZZLE_128B; 64: SWIZZLE_64B), 8-row
// groups 8 rows apart, 1024-byte aligned bases.
template <int DH>
struct Tile {
  static constexpr int ROW = DH * 2;
  static constexpr int BYTES = TILE * ROW;
  static constexpr uint64_t SWIZZLE = DH == 64 ? 1 : 2;  // descriptor layout type
  // K-major (the contraction along the rows): a k16 step is 32 bytes on
  static __device__ __forceinline__ uint64_t kmajor(uint32_t saddr) {
    return DH == 64 ? sm90::sw128_desc(saddr) : sm90::sw64_desc(saddr);
  }
  static constexpr int KSTEP = 32 >> 4;
  // MN-major (the contraction down the rows): SBO = 8 rows between 8-row
  // groups of the contraction; LBO, the step between DH-wide swizzle atoms,
  // is never used (DH is one atom) and holds the same value. A k16 step is
  // 16 rows on.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t saddr) {
    constexpr uint64_t group = (8 * ROW) >> 4;
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | (group << 16) | (group << 32) | (SWIZZLE << 62);
  }
  static constexpr int MNSTEP = (16 * ROW) >> 4;
  // The byte offset in the tile of the 16-byte chunk c of row r: the
  // swizzle XORs the chunk index with address bits 7-9 (128-byte rows: the
  // row's low three bits) or 7-8 (64-byte rows: bits 1-2 of the row).
  static __device__ __forceinline__ int chunk(int r, int c) {
    return r * ROW + 16 * (DH == 64 ? c ^ (r & 7) : c ^ ((r >> 1) & 3));
  }
};

// d (64 x 64) = (scale_d ? d : 0) + A (64 x 16) . B (64 x 16)^T, A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers: the accumulator
// layout of an m64n16 slice) . B (16 x 64), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same, 64 x 32.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x DH) += A (registers) . B (16 x DH, MN-major in shared memory)
template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&d)[DH / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

// TMA of one 64-row box at `row` of head p of sequence n. `slots` says
// which of the map's dimensions 1..3 is the row (bits 0-3), the head (4-7)
// and the sequence (8-11): the host orders them by stride.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, int slots,
                                          uint32_t bar, int row, int p, int n) {
  auto at = [&](int dim) { return (slots & 15) == dim ? row : ((slots >> 4) & 15) == dim ? p : n; };
  sm90::tma_load_4d(dst, map, bar, 0, at(1), at(2), at(3));
}

// Rotate row l of sequence n of q and k, every head, into the contiguous
// (N, P, L, DH) qr and kr: x[:h], x[h:] -> x[:h] cos - x[h:] sin,
// x[:h] sin + x[h:] cos with the (L, DH/2) fp32 tables at position l, 8
// pairs a lane of the calling warp. No fused multiply-add, rounded once to
// bf16: the bits of ops/rope.py::apply_rope_half in bf16.
template <int DH>
__device__ __forceinline__ void rotate_row(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                           bf16* __restrict__ qr, bf16* __restrict__ kr,
                                           const float* __restrict__ cos_t,
                                           const float* __restrict__ sin_t, long long n, int l,
                                           int L, int P, Strides sq, Strides sk, int lane) {
  constexpr int H = DH / 2, CH = H / 8;  // chunks per half row
  const float* cs = cos_t + (long long)l * H;
  const float* sn = sin_t + (long long)l * H;
  for (int c = lane; c < 2 * P * CH; c += 32) {
    const bool is_k = c >= P * CH;
    const int ci = is_k ? c - P * CH : c;
    const int h = ci / CH, d = (ci % CH) * 8;
    const bf16* src = is_k ? k + sk.at(n, h) + (long long)l * sk.l
                           : q + sq.at(n, h) + (long long)l * sq.l;
    bf16* dst = (is_k ? kr : qr) + ((n * P + h) * L + l) * DH;
    const uint4 ve = *reinterpret_cast<const uint4*>(src + d);
    const uint4 vo = *reinterpret_cast<const uint4*>(src + d + H);
    const bf16* pe = reinterpret_cast<const bf16*>(&ve);
    const bf16* po = reinterpret_cast<const bf16*>(&vo);
    uint4 re, ro;
    uint32_t* qe = reinterpret_cast<uint32_t*>(&re);
    uint32_t* qo = reinterpret_cast<uint32_t*>(&ro);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      float e2[2], o2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float e = __bfloat162float(pe[j + i]), od = __bfloat162float(po[j + i]);
        const float cv = cs[d + j + i], sv = sn[d + j + i];
        e2[i] = __fsub_rn(__fmul_rn(e, cv), __fmul_rn(od, sv));
        o2[i] = __fadd_rn(__fmul_rn(e, sv), __fmul_rn(od, cv));
      }
      qe[j / 2] = pack_bf16(e2[0], e2[1]);
      qo[j / 2] = pack_bf16(o2[0], o2[1]);
    }
    *reinterpret_cast<uint4*>(dst + d) = re;
    *reinterpret_cast<uint4*>(dst + d + H) = ro;
  }
}

// ---- host side

// The TMA map of an (N, P, L, DH) bf16 view for 64-row boxes. `spec` (from
// ops/attention_kernel.py::tma_map): the extents of dimensions 1..3, their
// strides in bytes, and the slots word (which of them is the row, head,
// sequence); dimension 0 is the contiguous DH. 0, or MAP_REFUSED plus the
// CUresult of cuTensorMapEncodeTiled.
constexpr int MAP_REFUSED = 100000;

inline int make_map4(CUtensorMap* map, const void* ptr, int dh, const long long* spec) {
  sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)spec[0], (cuuint64_t)spec[1],
                              (cuuint64_t)spec[2]};
  const cuuint64_t strides[3] = {(cuuint64_t)spec[3], (cuuint64_t)spec[4], (cuuint64_t)spec[5]};
  cuuint32_t box[4] = {(cuuint32_t)dh, 1, 1, 1};
  const int row_slot = (int)(spec[6] & 15);
  if (row_slot < 1 || row_slot > 3) return (int)cudaErrorInvalidValue;
  box[row_slot] = TILE;
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        dh == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_REFUSED + (int)r;
}

}  // namespace sam3
