// Int8 frozen-base GEMMs for Hopper (sm_90a): the three kernels of the int8
// tier (base_quant="int8"), bound with ctypes from ops/gemm_int8.py.
//
//   K4  replaces sam3_lora_tpu/ops/gemm_int8.py::int8_gemm_wres (Pallas body
//       _kernel): W8A8 y = (int8(x / s_x) . W_q^T) * s_x * s_w -> bf16, with
//       the per-row dynamic s_x = max(amax_row / 127, 1e-12). Two launches
//       behind sam3_int8_gemm: the row quantization (sam3_quant_rows: amax,
//       s_x and the int8 row, written once a row) and the mainloop of
//       gemm_sm90.cuh on s8 x s8 -> s32 (TMA ring, wgmma m64n256k32) with
//       the scaling epilogue and a TMA store.
//   K5  sam3_int8_lora_gemm replaces ::int8_lora_gemm_wres
//       (_make_lora_kernel): the W8A8 product plus the LoRA branch
//       scale * ((x A^T) B^T), on mma.sync (below, unchanged since its port).
//   K6  replaces ::bf16_gemm_wres_nt (_kernel_nt): the backward dx = dy .
//       dequant(W_q), fp32 accumulate. Two launches behind
//       sam3_bf16_gemm_nt: sam3_dequant_t writes W_deq^T (K, N) bf16 once,
//       then the same mainloop on bf16 x bf16 -> f32 (wgmma m64n256k16), dy
//       and W_deq^T both K-major along the contraction N.
//
// Layouts: x (M, K) bf16 row-major; the port's weight W_q is (N, K) int8
// row-major (out, in), the K-major B operand of the product as it stands;
// s_w (N,) fp32; lora_a (r, K) and lora_b (N, r) bf16; dy (M, N) bf16;
// outputs bf16. The wrappers admit K % 32 == 0, and N % 8 == 0 for K4 (its
// output rows are TMA-stored) and N % 32 == 0 for K6; M and N tails are
// masked (K5) or clipped by the TMA store (K4, K6).
//
// What bounds them on the H100: at the ViT shapes (M = 5184..41472, K x N up
// to 1024 x 4736) all three are far above the card's ridge point (2MKN
// operations against ~2(MK + MN) + KN bytes), so the bound is the tensor-core
// rate: 1979 TOP/s int8 for K4/K5, 989 TFLOP/s bf16 for K6. K4 and K6 feed
// the tensor cores through a TMA ring and wgmma (gemm_sm90.cuh); wgmma takes
// 8-bit operands only K-major from shared memory and TMA copies bytes as they
// are, so the row quantization (K4) and the dequantize-transpose (K6) are
// one pass each before the mainloop: 3 bytes per element of x, 3 per weight,
// in place of K4's quantization in every column block and K6's
// dequantization in every row block. K5 keeps its port's design: a block
// owns a 128 x 128 tile, takes its rows' scales in a prologue, quantizes
// each 32-wide K step of x into shared memory and runs mma.sync m16n8k32
// s8 x s8 -> s32, accumulating xa = x A^T on bf16 m16n8k16 in the same loop;
// its epilogue rounds xa to bf16 and multiplies by B^T (depth r padded to 16).
//
// Numerics (equal to ops/gemm_int8.py's plain versions): the division form
// x / s correctly rounded (no --use_fast_math; explicit _rn intrinsics so no
// multiply-add is contracted), round half to even (__float2int_rn), clip to
// +-127. |acc| <= K * 127^2 < 2^31 for K < 133144, so int32 cannot overflow;
// the int32 sum is exact, so K4 equals its plain version bit for bit. W_deq
// is bf16(fp32(q) * s_w), one rounding, the plain version's dequantize.

#include "attention_common.cuh"
#include "gemm_sm90.cuh"

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

// K5.
__global__ void __launch_bounds__(NTHREADS)
int8_lora_gemm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ ws, const bf16* __restrict__ la,
                 const bf16* __restrict__ lb, bf16* __restrict__ out, int M,
                 int N, int K, int r, float scale) {
  constexpr int LOOP_BYTES = 2 * TM * LD8 + (TM + MAX_RP) * LDX * 2;
  constexpr int EPI_BYTES = 2 * TM * LDR * 2;
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
  float xacc[MAX_RP / 8][4];  // xa of this warp's 16 rows (warp-th m16 tile)
#pragma unroll
  for (int j = 0; j < MAX_RP / 8; ++j) xacc[j][0] = xacc[j][1] = xacc[j][2] = xacc[j][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // x tile: quantize 8 values a chunk into As and keep bf16 in Xs
    for (int i = threadIdx.x; i < TM * (TK / 8); i += NTHREADS) {
      const int row = i / (TK / 8), c = (i % (TK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M) v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + row) * K + k0 + c);
      *reinterpret_cast<uint4*>(Xs + row * LDX + c) = v;
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
    // lora_a tile: rp rows (zero past r) of 32 bf16
    for (int i = threadIdx.x; i < rp * (TK / 8); i += NTHREADS) {
      const int row = i / (TK / 8), c = (i % (TK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < r) v = *reinterpret_cast<const uint4*>(la + (long long)row * K + k0 + c);
      *reinterpret_cast<uint4*>(Las + row * LDX + c) = v;
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
    __syncthreads();
  }

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

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    float delta[4][4];
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
          v[e] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(__float2bfloat16_rn(y)),
                                               __fmul_rn(delta[nj][h * 2 + e], scale)));
        }
        store2(out, row, col, N, v[0], v[1]);
      }
    }
  }
}


// K4's first pass: x (M, K) bf16 -> xq (M, K) int8 and s_x (M,) fp32, the
// plain version's quant_rows. T threads share a row (a warp for K <= 1024,
// the block's 256 for longer rows), each holding C 16-byte chunks of it in
// registers between the amax and the quantization: every load is in flight
// at once and x is read once. A row longer than T * C * 8 reads its tail
// twice.
template <int T, int C>
__global__ void __launch_bounds__(256)
quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                  int M, int K) {
  __shared__ float part[8];  // T = 256: each warp's amax
  const int t = threadIdx.x % T, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (256 / T) + threadIdx.x / T;
  const bool live = row < M;  // no early return: T = 256 syncs the block
  const bf16* src = x + (live ? row : 0) * K;
  int8_t* dst = xq + (live ? row : 0) * K;
  auto absmax = [](float a, const uint4& v) {
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) a = fmaxf(a, fabsf(__bfloat162float(e[j])));
    return a;
  };
  auto quantized = [](const uint4& v, float s) {
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j / 4] |= (uint32_t)(quant(__bfloat162float(e[j]), s) & 0xff) << (8 * (j % 4));
    return make_uint2(w[0], w[1]);
  };
  uint4 v[C];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = (i * T + t) * 8;
    v[i] = live && c < K ? *reinterpret_cast<const uint4*>(src + c) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < C; ++i) amax = absmax(amax, v[i]);
  for (int c = (C * T + t) * 8; live && c < K; c += T * 8)
    amax = absmax(amax, *reinterpret_cast<const uint4*>(src + c));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (T > 32) {
    if (lane == 0) part[threadIdx.x / 32] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < T / 32; ++w) amax = fmaxf(amax, part[w]);
  }
  if (!live) return;
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = (i * T + t) * 8;
    if (c < K) *reinterpret_cast<uint2*>(dst + c) = quantized(v[i], s);
  }
  for (int c = (C * T + t) * 8; c < K; c += T * 8)
    *reinterpret_cast<uint2*>(dst + c) = quantized(*reinterpret_cast<const uint4*>(src + c), s);
  if (t == 0) sx[row] = s;
}

// K6's first pass: W_q (N, K) int8 and s_w (N,) -> W_deq^T (K, N) bf16, one
// 64 x 64 tile a block through shared memory (N % 16 == 0, K % 16 == 0).
constexpr int DT = 64;
__global__ void __launch_bounds__(256)
dequant_t_kernel(const int8_t* __restrict__ wq, const float* __restrict__ ws,
                 bf16* __restrict__ out, int N, int K) {
  __shared__ __align__(16) bf16 tile[DT][DT + 8];  // [k][n]
  const int n0 = blockIdx.y * DT, k0 = blockIdx.x * DT;
  const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  float s = 0.f;
  if (n0 + r < N && k0 + c < K) {
    v = *reinterpret_cast<const uint4*>(wq + (long long)(n0 + r) * K + k0 + c);
    s = ws[n0 + r];
  }
  const int8_t* q = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) tile[c + i][r] = __float2bfloat16_rn(__fmul_rn((float)q[i], s));
  __syncthreads();
  if (k0 + r < K && n0 + c < N) {  // out row k0 + r, columns n0 + c .. + 15
    const uint4* src = reinterpret_cast<const uint4*>(&tile[r][c]);
    uint4* dst = reinterpret_cast<uint4*>(out + (long long)(k0 + r) * N + n0 + c);
    dst[0] = src[0];
    dst[1] = src[1];
  }
}

// The mainloop's two operations (gemm_sm90.cuh): rows() reads what the
// epilogue needs of a thread's rows (row, row + 8), pair() gives the bf16
// pairs of its columns col, col + 1 in those rows from d[4j .. 4j + 3] (the
// wgmma accumulator layout). Rows and columns past M and N are computed
// from zeros and clipped by the store.

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// K4: s8 x s8 -> s32, y = bf16((acc * s_x) * s_w), the plain version's order.
struct S8Scaled {
  using Acc = int;
  static constexpr int ELEM = 1;
  struct Params {
    const float* sx;
    const float* sw;
  };
  struct Rows {
    float a, b;  // s_x of the two rows
  };
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db, int sd) {
    sm90::wgmma_s8_n256(d, da, db, sd);
  }
  static __device__ __forceinline__ Rows rows(const Params& p, int row, int m) {
    return {row < m ? p.sx[row] : 0.f, row + 8 < m ? p.sx[row + 8] : 0.f};
  }
  static __device__ __forceinline__ bf16 scaled(int acc, float s, float w) {
    return __float2bfloat16_rn(__fmul_rn(__fmul_rn((float)acc, s), w));
  }
  static __device__ __forceinline__ void pair(const Params& p, const Rows& r, const int (&d)[128],
                                              int j, int col, int n, uint32_t& lo, uint32_t& hi) {
    const float w0 = col < n ? p.sw[col] : 0.f, w1 = col + 1 < n ? p.sw[col + 1] : 0.f;
    lo = pack2(scaled(d[4 * j], r.a, w0), scaled(d[4 * j + 1], r.a, w1));
    hi = pack2(scaled(d[4 * j + 2], r.b, w0), scaled(d[4 * j + 3], r.b, w1));
  }
};

// K6: bf16 x bf16 -> f32, rounded to bf16.
struct Bf16Plain {
  using Acc = float;
  static constexpr int ELEM = 2;
  struct Params {};
  struct Rows {};
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db, int sd) {
    sm90::wgmma_bf16_n256(d, da, db, sd);
  }
  static __device__ __forceinline__ Rows rows(const Params&, int, int) { return {}; }
  static __device__ __forceinline__ void pair(const Params&, const Rows&, const float (&d)[128],
                                              int j, int, int, uint32_t& lo, uint32_t& hi) {
    lo = pack_bf16(d[4 * j], d[4 * j + 1]);
    hi = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
};

}  // namespace

// C entry points, bound with ctypes. All operands contiguous; pointers to
// 16-byte aligned device memory. Each returns the cudaError_t of its launch
// (0 = success); shapes the kernel does not take return cudaErrorInvalidValue.

extern "C" int sam3_quant_rows(const void* x, void* xq, void* sx, int m, int k, void* stream) {
  if (m <= 0 || k <= 0 || k % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(sx);
  if (k <= 32 * 4 * 8)  // a warp a row, 8 rows a block
    quant_rows_kernel<32, 4><<<(m + 7) / 8, 256, 0, st>>>(xp, q, sp, m, k);
  else  // a block a row
    quant_rows_kernel<256, 4><<<m, 256, 0, st>>>(xp, q, sp, m, k);
  return (int)cudaGetLastError();
}

// K4: out (m, n) bf16 = (q(x) (m, k) . wq (n, k)^T) * s_x[:, None] * ws[None, :],
// the row quantization into xq (m, k) int8 and sx (m,) fp32, then the s8
// mainloop.
extern "C" int sam3_int8_gemm(const void* x, void* xq, void* sx, const void* wq, const void* ws,
                              void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 8) return (int)cudaErrorInvalidValue;
  const int err = sam3_quant_rows(x, xq, sx, m, k, stream);
  if (err) return err;
  const S8Scaled::Params p{static_cast<const float*>(sx), static_cast<const float*>(ws)};
  return sm90::launch<S8Scaled>(xq, wq, out, p, m, n, k, static_cast<cudaStream_t>(stream));
}

extern "C" int sam3_int8_lora_gemm(const void* x, const void* wq, const void* ws,
                                   const void* la, const void* lb, void* out, int m, int n,
                                   int k, int r, float scale, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % TK || r <= 0 || r % 8 || r > MAX_RP)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  int8_lora_gemm_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<const bf16*>(la),
      static_cast<const bf16*>(lb), static_cast<bf16*>(out), m, n, k, r, scale);
  return (int)cudaGetLastError();
}

// out (k, n) bf16 = (wq (n, k) int8 * ws[:, None])^T
extern "C" int sam3_dequant_t(const void* wq, const void* ws, void* out, int n, int k,
                              void* stream) {
  if (n <= 0 || k <= 0 || n % 16 || k % 16) return (int)cudaErrorInvalidValue;
  dim3 grid((k + DT - 1) / DT, (n + DT - 1) / DT);
  dequant_t_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws), static_cast<bf16*>(out), n,
      k);
  return (int)cudaGetLastError();
}

// K6: out (m, k) bf16 = dy (m, n) . dequant(wq (n, k), ws), contracting n:
// W_deq^T into wdt (k, n) bf16, then the bf16 mainloop on dy and wdt.
extern "C" int sam3_bf16_gemm_nt(const void* dy, const void* wq, const void* ws, void* wdt,
                                 void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 16 || k % 16) return (int)cudaErrorInvalidValue;
  const int err = sam3_dequant_t(wq, ws, wdt, n, k, stream);
  if (err) return err;
  return sm90::launch<Bf16Plain>(dy, wdt, out, Bf16Plain::Params{}, m, k, n,
                                 static_cast<cudaStream_t>(stream));
}
