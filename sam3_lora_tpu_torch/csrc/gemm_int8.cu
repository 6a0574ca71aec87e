// Int8 frozen-base GEMMs for Hopper (sm_90a): the three kernels of the int8
// tier (base_quant="int8"), bound with ctypes from ops/gemm_int8.py.
//
//   K4 sam3_int8_gemm       replaces sam3_lora_tpu/ops/gemm_int8.py
//                           ::int8_gemm_wres (Pallas body _kernel): fused W8A8
//                           y = (int8(x / s_x) . W_q^T) * s_x * s_w -> bf16,
//                           per-row dynamic s_x = max(amax_row / 127, 1e-12).
//   K5 sam3_int8_lora_gemm  replaces ::int8_lora_gemm_wres (_make_lora_kernel):
//                           K4 plus the LoRA branch scale * ((x A^T) B^T).
//   K6 sam3_bf16_gemm_nt    replaces ::bf16_gemm_wres_nt (_kernel_nt): the
//                           backward dx = dy . dequant(W_q), fp32 accumulate.
//
// Layouts: x (M, K) bf16 row-major; the port's weight W_q is (N, K) int8
// row-major (out, in), which is the K-contiguous "col" B operand of the
// product, so no transpose is needed; s_w (N,) fp32; lora_a (r, K) and
// lora_b (N, r) bf16; dy (M, N) bf16; outputs bf16. K % 32 == 0 (and for K6
// N % 32 == 0); M and N tails are masked.
//
// What bounds them on the H100: at the ViT shapes (M = 5184..20736, K x N up
// to 1024 x 4736) all three are far above the card's ridge point (2MKN
// operations against ~2(MK + MN) + KN bytes), so the bound is the tensor-core
// rate: 1979 TOP/s int8 for K4/K5, 989 TFLOP/s bf16 for K6. The design keeps
// quantization and dequantization out of device memory, as the TPU kernel
// does: a block owns a 128 x 128 output tile (8 warps of 64 x 32); its
// prologue takes the row scales of its 128 rows (re-reading x, mostly from
// L2), then each 32-wide K step quantizes the bf16 x tile into shared memory
// and runs mma.sync m16n8k32 s8 x s8 -> s32 from 32-bit shared loads. The
// epilogue scales the int32 sums in fp32 and writes bf16. K5 accumulates
// xa = x A^T on bf16 m16n8k16 mma.sync in the same K loop, rounds it to bf16
// and multiplies by B^T (depth r, padded to 16 with zeros) in the epilogue.
// K6 dequantizes each int8 W tile on its way to shared memory (bf16, the bits
// of the plain version's dequant) and feeds it transposed by ldmatrix.trans.
// Left for later: wgmma/TMA pipelines and overlap of the loads with the math.
//
// Numerics (equal to ops/gemm_int8.py's plain versions): the division form
// x / s correctly rounded (no --use_fast_math; explicit _rn intrinsics so no
// multiply-add is contracted), round half to even (__float2int_rn), clip to
// +-127. |acc| <= 4736 * 127^2 < 2^31, so int32 cannot overflow; the int32 sum
// is exact, so K4 equals its plain version bit for bit.

#include "attention_common.cuh"

namespace {

using namespace sam3;

constexpr int TM = 128;           // output rows per block
constexpr int TN = 128;           // output columns per block
constexpr int TK = 32;            // contraction step
constexpr int NWARPS = 8;         // 2 (rows) x 4 (columns) warps of 64 x 32
constexpr int NTHREADS = NWARPS * 32;
constexpr int LD8 = TK + 16;      // int8 tile row stride, bytes (conflict-free)
constexpr int LDX = TK + 8;       // bf16 x / A / dy tile row stride, elements
constexpr int MAX_RP = 64;        // largest LoRA rank (padded to 16)
constexpr int LDR = MAX_RP + 8;   // bf16 xa / B tile row stride, elements
constexpr int LDW = TN + 8;       // bf16 dequantized W tile row stride (K6)

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ int quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
}

// Store two adjacent outputs of row `row` at cols col, col + 1 (masked).
__device__ __forceinline__ void store2(bf16* out, long long row, int col, int n,
                                       bf16 v0, bf16 v1) {
  bf16* p = out + row * n + col;
  if (col + 1 < n && (n & 1) == 0) {
    __nv_bfloat162 v;
    v.x = v0;
    v.y = v1;
    *reinterpret_cast<__nv_bfloat162*>(p) = v;
  } else {
    if (col < n) p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

// K4 (LORA = false) and K5 (LORA = true).
template <bool LORA>
__global__ void __launch_bounds__(NTHREADS)
int8_gemm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ ws, const bf16* __restrict__ la,
                 const bf16* __restrict__ lb, bf16* __restrict__ out, int M,
                 int N, int K, int r, float scale) {
  constexpr int LOOP_BYTES = 2 * TM * LD8 + (LORA ? (TM + MAX_RP) * LDX * 2 : 0);
  constexpr int EPI_BYTES = LORA ? 2 * TM * LDR * 2 : 0;
  constexpr int BYTES = LOOP_BYTES > EPI_BYTES ? LOOP_BYTES : EPI_BYTES;
  __shared__ __align__(16) unsigned char smem[BYTES];
  __shared__ float sx[TM];
  int8_t* As = reinterpret_cast<int8_t*>(smem);          // [TM][LD8] int8 x
  int8_t* Bs = As + TM * LD8;                            // [TN][LD8] int8 W
  bf16* Xs = reinterpret_cast<bf16*>(Bs + TN * LD8);     // [TM][LDX] bf16 x
  bf16* Las = Xs + TM * LDX;                             // [MAX_RP][LDX] lora_a
  bf16* XAs = reinterpret_cast<bf16*>(smem);             // epilogue: [TM][LDR] xa
  bf16* LBs = XAs + TM * LDR;                            // epilogue: [TN][LDR] lora_b

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;  // this warp's 64 x 32 of the tile
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int rp = (r + 15) & ~15;            // LoRA depth padded to the k16 step

  // prologue: s_x of this block's rows, one warp per 16 rows
  for (int i = 0; i < TM / NWARPS; ++i) {
    const int row = warp * (TM / NWARPS) + i;
    float amax = 0.f;
    if (m0 + row < M) {
      const bf16* src = x + (long long)(m0 + row) * K;
      for (int c = lane * 8; c < K; c += 32 * 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + c);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) sx[row] = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  }
  __syncthreads();

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;
  float xacc[MAX_RP / 8][4];  // K5: xa of this warp's 16 rows (warp-th m16 tile)
#pragma unroll
  for (int j = 0; j < MAX_RP / 8; ++j) xacc[j][0] = xacc[j][1] = xacc[j][2] = xacc[j][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // x tile: quantize 8 values a chunk into As (and keep bf16 in Xs for K5)
    for (int i = threadIdx.x; i < TM * (TK / 8); i += NTHREADS) {
      const int row = i / (TK / 8), c = (i % (TK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M) v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + row) * K + k0 + c);
      if (LORA) *reinterpret_cast<uint4*>(Xs + row * LDX + c) = v;
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      const float s = sx[row];
      uint32_t packed[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w |= (uint32_t)(quant(__bfloat162float(e[h * 4 + j]), s) & 0xff) << (8 * j);
        packed[h] = w;
      }
      *reinterpret_cast<uint2*>(As + row * LD8 + c) = make_uint2(packed[0], packed[1]);
    }
    // W tile: TN rows of 32 int8
    for (int i = threadIdx.x; i < TN * (TK / 16); i += NTHREADS) {
      const int row = i / (TK / 16), c = (i % (TK / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + row < N) v = *reinterpret_cast<const uint4*>(wq + (long long)(n0 + row) * K + k0 + c);
      *reinterpret_cast<uint4*>(Bs + row * LD8 + c) = v;
    }
    if (LORA) {  // lora_a tile: rp rows (zero past r) of 32 bf16
      for (int i = threadIdx.x; i < rp * (TK / 8); i += NTHREADS) {
        const int row = i / (TK / 8), c = (i % (TK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < r) v = *reinterpret_cast<const uint4*>(la + (long long)row * K + k0 + c);
        *reinterpret_cast<uint4*>(Las + row * LDX + c) = v;
      }
    }
    __syncthreads();

    uint32_t a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* p = As + (wm * 64 + mi * 16 + g) * LD8 + t * 4;
      a[mi][0] = lds32(p);
      a[mi][1] = lds32(p + 8 * LD8);
      a[mi][2] = lds32(p + 16);
      a[mi][3] = lds32(p + 8 * LD8 + 16);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int8_t* p = Bs + (wn * 32 + nj * 8 + g) * LD8 + t * 4;
      const uint32_t b0 = lds32(p), b1 = lds32(p + 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) mma_s8(acc[mi][nj], a[mi], b0, b1);
    }
    if (LORA) {
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t xa_a[4];
        load_a(xa_a, Xs + warp * 16 * LDX + kk * 16, LDX);
#pragma unroll
        for (int j = 0; j < MAX_RP / 8; j += 2) {
          if (j * 8 < rp) {
            uint32_t b[4];
            load_b_nk(b, Las + j * 8 * LDX + kk * 16, LDX);
            mma(xacc[j], xa_a, b[0], b[1]);
            mma(xacc[j + 1], xa_a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (LORA) {
    // xa rounded to bf16 (the plain version's rounding point) into XAs, and
    // the lora_b tile into LBs; both zero past r
#pragma unroll
    for (int j = 0; j < MAX_RP / 8; ++j) {
      if (j * 8 < rp) {
        bf16* p = XAs + (warp * 16 + g) * LDR + j * 8 + t * 2;
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(xacc[j][0], xacc[j][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * LDR) = pack_bf16(xacc[j][2], xacc[j][3]);
      }
    }
    for (int i = threadIdx.x; i < TN * (rp / 8); i += NTHREADS) {
      const int row = i / (rp / 8), c = (i % (rp / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + row < N && c < r) v = *reinterpret_cast<const uint4*>(lb + (long long)(n0 + row) * r + c);
      *reinterpret_cast<uint4*>(LBs + row * LDR + c) = v;
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    float delta[4][4];
    if (LORA) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) delta[nj][0] = delta[nj][1] = delta[nj][2] = delta[nj][3] = 0.f;
      for (int kk = 0; kk < rp / 16; ++kk) {
        uint32_t da[4];
        load_a(da, XAs + (wm * 64 + mi * 16) * LDR + kk * 16, LDR);
#pragma unroll
        for (int nj = 0; nj < 4; nj += 2) {
          uint32_t b[4];
          load_b_nk(b, LBs + (wn * 32 + nj * 8) * LDR + kk * 16, LDR);
          mma(delta[nj], da, b[0], b[1]);
          mma(delta[nj + 1], da, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lrow = wm * 64 + mi * 16 + g + h * 8;
      const long long row = m0 + lrow;
      if (row >= M) continue;
      const float s = sx[lrow];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + wn * 32 + nj * 8 + t * 2;
        bf16 v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sw = col + e < N ? ws[col + e] : 0.f;
          const float y = __fmul_rn(__fmul_rn((float)acc[mi][nj][h * 2 + e], s), sw);
          v[e] = __float2bfloat16_rn(y);
          if (LORA)
            v[e] = __float2bfloat16_rn(
                __fadd_rn(__bfloat162float(v[e]), __fmul_rn(delta[nj][h * 2 + e], scale)));
        }
        store2(out, row, col, N, v[0], v[1]);
      }
    }
  }
}

// K6: dx (M, K) = dy (M, N) . dequant(W_q (N, K), s_w (N,)), contracting N.
__global__ void __launch_bounds__(NTHREADS)
bf16_gemm_nt_kernel(const bf16* __restrict__ dy, const int8_t* __restrict__ wq,
                    const float* __restrict__ ws, bf16* __restrict__ out, int M,
                    int N, int K) {
  __shared__ __align__(16) bf16 Ds[TM * LDX];  // [TM][LDX] dy tile
  __shared__ __align__(16) bf16 Ws[TK * LDW];  // [TK][LDW] dequantized W tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * TM, k0 = blockIdx.x * TN;  // output rows, cols

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int c0 = 0; c0 < N; c0 += TK) {
    for (int i = threadIdx.x; i < TM * (TK / 8); i += NTHREADS) {
      const int row = i / (TK / 8), c = (i % (TK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M) v = *reinterpret_cast<const uint4*>(dy + (long long)(m0 + row) * N + c0 + c);
      *reinterpret_cast<uint4*>(Ds + row * LDX + c) = v;
    }
    for (int i = threadIdx.x; i < TK * (TN / 16); i += NTHREADS) {
      const int row = i / (TN / 16), c = (i % (TN / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + c < K) v = *reinterpret_cast<const uint4*>(wq + (long long)(c0 + row) * K + k0 + c);
      const int8_t* q = reinterpret_cast<const int8_t*>(&v);
      const float s = ws[c0 + row];
      uint32_t d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = pack_bf16(__fmul_rn((float)q[2 * j], s), __fmul_rn((float)q[2 * j + 1], s));
      *reinterpret_cast<uint4*>(Ws + row * LDW + c) = make_uint4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<uint4*>(Ws + row * LDW + c + 8) = make_uint4(d[4], d[5], d[6], d[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) load_a(a[mi], Ds + (wm * 64 + mi * 16) * LDX + kk * 16, LDX);
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t b[4];
        load_b_kn(b, Ws + kk * 16 * LDW + wn * 32 + nj * 8, LDW);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma(acc[mi][nj], a[mi], b[0], b[1]);
          mma(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = k0 + wn * 32 + nj * 8 + t * 2;
        store2(out, row, col, K, __float2bfloat16_rn(acc[mi][nj][h * 2]),
               __float2bfloat16_rn(acc[mi][nj][h * 2 + 1]));
      }
    }
}

}  // namespace

// C entry points, bound with ctypes. All operands contiguous; pointers to
// 16-byte aligned device memory. Each returns the cudaError_t of its launch
// (0 = success); shapes the kernel does not take return cudaErrorInvalidValue.

extern "C" int sam3_int8_gemm(const void* x, const void* wq, const void* ws, void* out,
                              int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % TK) return (int)cudaErrorInvalidValue;
  dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  int8_gemm_kernel<false><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), nullptr, nullptr, static_cast<bf16*>(out), m, n, k, 0,
      0.f);
  return (int)cudaGetLastError();
}

extern "C" int sam3_int8_lora_gemm(const void* x, const void* wq, const void* ws,
                                   const void* la, const void* lb, void* out, int m, int n,
                                   int k, int r, float scale, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % TK || r <= 0 || r % 8 || r > MAX_RP)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  int8_gemm_kernel<true><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<const bf16*>(la),
      static_cast<const bf16*>(lb), static_cast<bf16*>(out), m, n, k, r, scale);
  return (int)cudaGetLastError();
}

extern "C" int sam3_bf16_gemm_nt(const void* dy, const void* wq, const void* ws, void* out,
                                 int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % TK || n % TK) return (int)cudaErrorInvalidValue;
  dim3 grid((k + TN - 1) / TN, (m + TM - 1) / TM);
  bf16_gemm_nt_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<bf16*>(out), m, n, k);
  return (int)cudaGetLastError();
}
