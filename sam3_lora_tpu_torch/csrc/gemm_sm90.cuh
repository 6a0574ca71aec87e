// One GEMM mainloop for Hopper (sm_90a), shared by the int8 tier's K4
// (s8 x s8 -> s32) and K6 (bf16 x bf16 -> f32) in gemm_int8.cu:
//
//   C (M, N) bf16 = epilogue(A (M, K) . B (N, K)^T), both operands K-major
//   (row-major with the contraction contiguous).
//
// Design: a persistent grid (one CTA per SM walks the 128 x 256 output tiles,
// the N tiles of one row block next to each other, so a row block of A is
// read from device memory once and the weight panel stays in L2). Three
// warpgroups: one producer thread keeps TMA loads (cp.async.bulk.tensor.2d,
// 128-byte swizzle) in flight into a ring of STAGES stages, each stage 128
// bytes of K for the A tile (128 rows) and the B tile (256 rows), with a
// full and an empty mbarrier; two consumer warpgroups each own 64 rows of
// the tile and issue wgmma.mma_async m64n256 (k32 for s8, k16 for bf16: 32
// bytes of K either way, four per stage) on each stage as it arrives. A
// consumer releases a stage once the wgmma group that read it has retired
// (wait_group 1 after the next stage's group is committed), so the tensor
// cores never wait on their own release. The sums stay in registers (128 a
// thread); the epilogue scales and rounds them into a bf16 tile in shared
// memory (128-byte swizzled 64 x 64 boxes, no bank conflicts) and TMA
// stores it (cp.async.bulk.tensor, clipped at M and N), so the tile's
// device-memory writes drain while the warpgroup is already on its next
// tile, and the producer has been loading that tile since stages came free.
// Registers: setmaxnreg gives the producer warpgroup 40 a thread and the
// consumers 232.
//
// Tile: 128 x 256 outputs by 128 bytes of K. m64n256 is wgmma's widest
// shape, so each byte of A brought to shared memory feeds 256 outputs; a
// stage is 48 KB, and three of them with the 64 KB output tile fill 209 KB
// of dynamic shared memory (one CTA per SM). The output goes through shared
// memory and TMA because stores straight from registers keep a CTA's tensor
// cores idle while it writes its tile, which weighs most where a tile has
// few stages (K = 1024: 8). TMA fills rows past M or N (and K past its end)
// with zeros and the store clips them, so ragged shapes need no masking.
//
// The wgmma descriptors match the TMA box: 128-byte rows, 128-byte swizzle,
// 8-row groups 1024 bytes apart (SBO), stage bases 1024-byte aligned; a
// 32-byte K step advances the start address by 2 (16-byte units). The
// barriers, TMA, descriptors and register controls are sm90.cuh's, shared
// with the attention backward.
//
// An Op with LORA = true (K5's) adds a low-rank step to each tile: after the
// tile's last K block the producer loads one more ring slot, the tile's 128
// rows of xa (M, r) and 256 rows of lora_b (N, r) after them, both bf16 in
// boxes p.row_bytes wide (32, 64 or 128 bytes for r up to 16, 32 or 64,
// swizzled as wide; TMA fills the columns past r with zeros), and sets that
// slot's expect_tx to their bytes; the consumers turn their int32 sums
// into the fp32 values Op::lora_y gives (K5: bf16(acc s_x s_w), widened),
// run ceil(r / 16) wgmma m64n256k16 bf16 steps on that slot accumulating
// onto them in the same registers, release the slot and store the bf16 tile
// as K4 does. Each tile so takes kblocks + 1 slots on both sides of the ring.
// K4's and K6's instances (LORA = false) compile none of it.

#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace sam3 {
namespace sm90 {

constexpr int BM = 128;            // tile rows: two consumer warpgroups of 64
constexpr int BN = 256;            // tile columns: one m64n256 wgmma per K step
constexpr int KBYTES = 128;        // bytes of K per stage: one swizzle row
constexpr int STAGES = 3;
constexpr int A_BYTES = BM * KBYTES;
constexpr int B_BYTES = BN * KBYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int C_BYTES = BM * BN * 2;  // the bf16 output tile: 2 x 4 boxes of 64 x 64
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + C_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, alignment
constexpr int THREADS = 3 * 128;

// d (64 x 256 per warpgroup) += A (64 x 32 bytes) . B (256 x 32 bytes)^T;
// scale_d == 0 overwrites d. Thread t of the warpgroup holds, for j in
// 0..31, d[4j + 2h + e] at row 16 (t / 32) + (t % 32) / 4 + 8h, column
// 8j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Two fp32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the kernel

// Op: Acc (int or float), ELEM (bytes per element of A and B), mma (one
// 32-byte K step), Params, Rows rows(p, row, m) (what the epilogue needs of
// a thread's rows row and row + 8) and pair(p, rows, d, j, col, n, lo, hi):
// the bf16 pairs of columns col, col + 1 of those two rows from d[4j..4j+3].
// LORA: whether the tile ends with the low-rank step; an Op with it also
// has lora_y(p, rows, d, j, col, n, y) (y[4j..4j+3] from d[4j..4j+3]) and
// Params members txa, tlb (the TMA maps of xa and lora_b), ksteps and
// row_bytes.
template <class Op>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc, const __grid_constant__ typename Op::Params p,
            int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (cvta_smem(smem_raw) + 1023u) & ~1023u;
  const uint32_t c_tile = base + STAGES * STAGE_BYTES;
  const uint32_t bars = c_tile + C_BYTES;
  auto a_stage = [&](int s) { return base + s * STAGE_BYTES; };
  auto b_stage = [&](int s) { return base + s * STAGE_BYTES + A_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx; TMA completes the bytes
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  constexpr int KE = KBYTES / Op::ELEM;  // elements of K per stage
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = ((m + BM - 1) / BM) * tiles_n;
  const int kblocks = (k + KE - 1) / KE;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // producer
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(empty(s), ph ^ 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          tma_load_2d(a_stage(s), &ta, full(s), kb * KE, m0);
          tma_load_2d(b_stage(s), &tb, full(s), kb * KE, n0);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
        if constexpr (Op::LORA) {  // the tile's low-rank operands: one more slot
          mbar_wait(empty(s), ph ^ 1);
          mbar_expect_tx(full(s), (BM + BN) * p.row_bytes);
          tma_load_2d(a_stage(s), &p.txa, full(s), 0, m0);
          tma_load_2d(a_stage(s) + BM * p.row_bytes, &p.tlb, full(s), 0, n0);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. + 63 of each tile
    reg_alloc<232>();
    const int cw = wg - 1;
    const bool leader = threadIdx.x % 128 == 0;
    const int lane = threadIdx.x % 32;
    const int r0 = (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows r0, r0 + 8 of the 64
    const uint32_t c_own = c_tile + cw * (C_BYTES / 2);        // 4 boxes of 64 x 64 bf16
    typename Op::Acc acc[128];
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
      int prev = 0;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(full(s), ph);
        const uint64_t da = sw128_desc(a_stage(s) + cw * 64 * KBYTES);
        const uint64_t db = sw128_desc(b_stage(s));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KBYTES / 32; ++kk) Op::mma(acc, da + 2 * kk, db + 2 * kk, kb | kk);
        wgmma_commit();
        if (kb > 0) {  // the previous stage's group has retired: free its stage
          wgmma_wait<1>();
          if (leader) mbar_arrive(empty(prev));
        }
        prev = s;
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (leader) mbar_arrive(empty(prev));

      // epilogue: once the last tile's stores have read the output tile,
      // write this one there (128-byte swizzle: 16-byte chunk c of row r at
      // c ^ (r % 8)) and store it
      auto put = [&](int j, uint32_t lo, uint32_t hi) {
        const uint32_t at = c_own + (j / 8) * 8192 + (((j % 8) ^ (r0 % 8)) << 4) + 4 * (lane % 4);
        st_shared_u32(at + r0 * 128, lo);
        st_shared_u32(at + (r0 + 8) * 128, hi);
      };
      if constexpr (Op::LORA) {
        // the low-rank step: y (fp32, in place of the int32 sums as far as
        // the register allocator goes) += xa . lora_b^T over the slot; the
        // ordinary writes of y are pinned before the fence that orders them
        // ahead of the wgmma that accumulates onto them
        const typename Op::Rows rows = Op::rows(p, m0 + cw * 64 + r0, m);
        float y[128];
#pragma unroll
        for (int j = 0; j < 32; ++j) Op::lora_y(p, rows, acc, j, n0 + 8 * j + 2 * (lane % 4), n, y);
        fence_regs(y);
        mbar_wait(full(s), ph);
        wgmma_fence();
        const uint64_t da = swizzled_desc(a_stage(s) + cw * 64 * p.row_bytes, p.row_bytes);
        const uint64_t db = swizzled_desc(a_stage(s) + BM * p.row_bytes, p.row_bytes);
#pragma unroll
        for (int kk = 0; kk < KBYTES / 32; ++kk)
          if (kk < p.ksteps) wgmma_bf16_n256(y, da + 2 * kk, db + 2 * kk, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(y);
        if (leader) mbar_arrive(empty(s));
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
        if (leader) bulk_wait_read();
        warpgroup_sync(1 + cw);
#pragma unroll
        for (int j = 0; j < 32; ++j)
          put(j, bf16x2(y[4 * j], y[4 * j + 1]), bf16x2(y[4 * j + 2], y[4 * j + 3]));
        // the sums' registers carry y's bits to the next tile's first wgmma,
        // which overwrites them (scale_d = 0): the old sums die here
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = __float_as_int(y[i]);
      } else {
        if (leader) bulk_wait_read();
        warpgroup_sync(1 + cw);
        const typename Op::Rows rows = Op::rows(p, m0 + cw * 64 + r0, m);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          uint32_t lo, hi;
          Op::pair(p, rows, acc, j, n0 + 8 * j + 2 * (lane % 4), n, lo, hi);
          put(j, lo, hi);
        }
      }
      fence_async_smem();
      warpgroup_sync(1 + cw);
      if (leader) {
#pragma unroll
        for (int q = 0; q < 4; ++q) tma_store_2d(&tc, c_own + q * 8192, n0 + 64 * q, m0 + cw * 64);
        bulk_commit();
      }
    }
    if (leader) bulk_wait();
  }
}

// ---- host side

// The TMA map of a row-major (rows, cols) operand with `elem`-byte elements,
// cut into boxes of box_bytes (128, 64 or 32) bytes of a row by box_rows
// rows, swizzled as wide; reads out of range fill zeros. 0, or a
// cudaError_t.
inline int make_map(CUtensorMap* map, const void* ptr, long long rows, long long cols, int elem,
                    int box_rows, int box_bytes = KBYTES) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)(box_bytes / elem), (cuuint32_t)box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(ptr), dims, strides, box, estrides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// out (m, n) bf16 = Op's epilogue of A (m, k) . B (n, k)^T, on `stream`, one
// persistent CTA per SM (fewer if there are fewer tiles). Rows of A, B and
// out must be 16-byte aligned. 0, or a cudaError_t.
template <class Op>
int launch(const void* a, const void* b, void* out, const typename Op::Params& p, int m, int n,
           int k, cudaStream_t stream) {
  CUtensorMap ta, tb, tc;
  int err = (int)bind_primary_context();
  if (!err) err = make_map(&ta, a, m, k, Op::ELEM, BM);
  if (!err) err = make_map(&tb, b, n, k, Op::ELEM, BN);
  if (!err) err = make_map(&tc, out, m, n, 2, 64);
  if (err) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  const long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_kernel<Op><<<grid, THREADS, SMEM_BYTES, stream>>>(ta, tb, tc, p, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace sam3
