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
//   K5  replaces ::int8_lora_gemm_wres (_make_lora_kernel): the W8A8 product
//       plus the LoRA branch scale * ((x A^T) B^T). Two launches behind
//       sam3_int8_lora_gemm: one pass over x writes K4's row quantization and
//       xa = bf16(scale * x A^T) (mma.sync), then K4's mainloop with a
//       low-rank step at the end of each tile (wgmma m64n256k16 on xa, B).
//   K6  replaces ::bf16_gemm_wres_nt (_kernel_nt): the backward dx = dy .
//       dequant(W_q), fp32 accumulate. Two launches behind
//       sam3_bf16_gemm_nt: sam3_dequant_t writes W_deq^T (K, N) bf16 once,
//       then the same mainloop on bf16 x bf16 -> f32 (wgmma m64n256k16), dy
//       and W_deq^T both K-major along the contraction N.
//
// Layouts: x (M, K) bf16 row-major; the port's weight W_q is (N, K) int8
// row-major (out, in), the K-major B operand of the product as it stands;
// s_w (N,) fp32; lora_a (r, K) and lora_b (N, r) bf16; dy (M, N) bf16;
// outputs bf16. The wrappers admit K % 32 == 0, N % 8 == 0 for K4 and K5
// (their output rows are TMA-stored) and N % 32 == 0 for K6, and for K5 a
// rank r % 8 == 0 (16-byte rows of xa and lora_b for TMA) up to 64; M and N
// tails are zero-filled by the TMA loads and clipped by the TMA store.
//
// What bounds them on the H100: at the ViT shapes (M = 5184..41472, K x N up
// to 1024 x 4736) all three are far above the card's ridge point (2MKN
// operations against ~2(MK + MN) + KN bytes), so the bound is the tensor-core
// rate: 1979 TOP/s int8 for K4/K5, 989 TFLOP/s bf16 for K6. They feed the
// tensor cores through a TMA ring and wgmma (gemm_sm90.cuh); wgmma takes
// 8-bit operands only K-major from shared memory and TMA copies bytes as they
// are, so the row quantization (K4, K5) and the dequantize-transpose (K6) are
// one pass each before the mainloop: 3 bytes per element of x, 3 per weight,
// in place of a quantization of x in every column block and a
// dequantization of W in every row block. K5's adapter products add
// 2Mr(K + N) bf16 operations, at the bf16 rate 2% of the int8 product's
// time at rank 8 and 15% at rank 64 (fc1). Its first pass computes xa while
// it quantizes (2Mr more bytes written); the low-rank step costs each tile
// one more ring slot and ceil(r / 16) bf16 wgmmas onto the sums already in
// registers, so the (M, N) delta never reaches device memory. The JAX
// kernel's design note asks the same of the TPU (the delta add fused into
// the output write).
//
// K5's design departs from the recommended one in two ways. Its row
// quantization is a pass of its own that also computes xa (K4's pass and a
// separate xa pass cost a launch more and, on an H100, more device time at
// fc2 than the one pass); and the scale is folded into xa (xa = bf16(fp32(scale * xa_f32))) rather
// than applied to the delta, so the delta can accumulate onto y in the sums'
// registers. For a power of two scale (alpha / r usually is) that equals the
// plain version's order up to summation order; otherwise xa carries one more
// bf16 rounding, within the tolerance (tests/test_torch_k5.py). Tried on the
// same card and not kept, both slower at qkv and fc1: the low-rank operands
// in the output tile's idle shared memory, loaded during the tile's K loop
// rather than in a slot after it (the hand-over waits on the last tile's
// stores), and 64-column boxes at every rank (more bytes of zeros through
// TMA and shared memory at rank 8 than boxes as wide as the rank).
//
// Numerics (equal to ops/gemm_int8.py's plain versions): the division form
// x / s correctly rounded (no --use_fast_math; explicit _rn intrinsics so no
// multiply-add is contracted), round half to even (__float2int_rn), clip to
// +-127. |acc| <= K * 127^2 < 2^31 for K < 133144, so int32 cannot overflow;
// the int32 sum is exact, so K4 equals its plain version bit for bit, and K5's
// y (rounded to bf16 before the adapter sum is added, as the plain version
// rounds it) is K4's output. W_deq is bf16(fp32(q) * s_w), one rounding, the
// plain version's dequantize.

#include "attention_common.cuh"
#include "gemm_sm90.cuh"

namespace {

using namespace sam3;

constexpr int MAX_RANK = 64;  // K5's largest adapter rank

__device__ __forceinline__ int quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
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

// K5's first pass: the row quantization and xa together. x (M, K) bf16 ->
// xq (M, K) int8 and s_x (M,) fp32, the bits of quant_rows_kernel (the same
// division and rounding; an amax is exact in any order), and xa (M, r) bf16
// = bf16(fp32(scale * (x . la^T))), the sums in fp32 on mma.sync m16n8k16.
// A block owns 16 rows; its PW warps take every PW-th 32-wide K step. Pass
// 1: per K step a thread loads 16 bytes of each of its rows (g, g + 8) and
// of row g of each 8-row group of la straight from device memory (its 8
// contiguous K positions fill fragment slots 2t, 2t + 1, 2t + 8, 2t + 9 of
// two k16 products, the same permutation of K on both operands, so neither
// needs shared memory or ldmatrix) and keeps its rows' amax. The warps'
// partial sums and amaxes meet in shared memory, added in a fixed order.
// Pass 2 reads the same bytes of x again, the last read first, and writes
// them quantized. Bound by the bytes: x read (2MK; twice where the second
// read misses L2), xq written (MK), xa (2Mr); la (2rK) comes from L2 to
// every block. Eight warps a block keep each warp's chain of dependent loads
// short (4 K steps at K = 1024). quant_rows_kernel's row ownership (a warp
// or a block a row) does not fit the tensor cores' 16-row tiles, hence a
// kernel of its own rather than an xa product inside that pass. Tried on an
// H100 and not kept, both slower: the rows held in shared memory between the
// passes (one block an SM at K = 4736) and one persistent block an SM
// walking the row groups.
constexpr int PW = 8;  // the first pass's warps a block
template <int NT>
__global__ void __launch_bounds__(PW * 32)
lora_prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ la, int8_t* __restrict__ xq,
                 float* __restrict__ sx, bf16* __restrict__ xa, int M, int K, float scale) {
  constexpr int R = NT * 8;                          // the rank
  constexpr int U = NT <= 4 ? 4 : 2;                 // K steps in flight a warp, pass 1
  constexpr int U2 = 4;                              // the same, pass 2
  __shared__ float part[PW][16 * R];                 // each warp's partial sums
  __shared__ float amax_part[PW][16];
  __shared__ float srow[16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const long long row0 = (long long)blockIdx.x * 16;
  const bf16* xr[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 8 * h + g;
    live[h] = row < M;
    xr[h] = x + (live[h] ? row : 0) * K + 8 * t;
  }
  const bf16* ar = la + (long long)g * K + 8 * t;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto ld = [](const bf16* p) { return __ldg(reinterpret_cast<const uint4*>(p)); };
  auto absmax = [](float a, const uint4& v) {
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) a = fmaxf(a, fabsf(__bfloat162float(e[j])));
    return a;
  };
  float acc[NT][4], amx[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int steps = K / 32;
  const int mine = (steps - warp + PW - 1) / PW;  // this warp's steps: warp + PW i, i < mine
  for (int i0 = 0; i0 < mine; i0 += U) {
    uint4 xv[U][2], av[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = i0 + u < mine;
      const int k0 = (warp + PW * (i0 + u)) * 32;
#pragma unroll
      for (int h = 0; h < 2; ++h) xv[u][h] = ok && live[h] ? ld(xr[h] + k0) : zero;
#pragma unroll
      for (int j = 0; j < NT; ++j) av[u][j] = ok ? ld(ar + (long long)j * 8 * K + k0) : zero;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint4 &lo = xv[u][0], &hi = xv[u][1];
      amx[0] = absmax(amx[0], lo);
      amx[1] = absmax(amx[1], hi);
      const uint32_t f0[4] = {lo.x, hi.x, lo.y, hi.y}, f1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma(acc[j], f0, av[u][j].x, av[u][j].y);
        mma(acc[j], f1, av[u][j].z, av[u][j].w);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row's amax over the four threads of its group
    float v = amx[h];
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    if (t == 0) amax_part[warp][8 * h + g] = v;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float* p = part[warp] + g * R + 8 * j + 2 * t;
    p[0] = acc[j][0];
    p[1] = acc[j][1];
    p[8 * R] = acc[j][2];
    p[8 * R + 1] = acc[j][3];
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    float a = amax_part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < PW; ++w) a = fmaxf(a, amax_part[w][threadIdx.x]);
    const float s = fmaxf(__fdiv_rn(a, 127.f), 1e-12f);
    srow[threadIdx.x] = s;
    if (row0 + threadIdx.x < M) sx[row0 + threadIdx.x] = s;
  }
  for (int e = 2 * threadIdx.x; e < 16 * R; e += 2 * PW * 32) {
    const long long row = row0 + e / R;
    if (row >= M) continue;
    float v0 = part[0][e], v1 = part[0][e + 1];
#pragma unroll
    for (int w = 1; w < PW; ++w) {
      v0 = __fadd_rn(v0, part[w][e]);
      v1 = __fadd_rn(v1, part[w][e + 1]);
    }
    *reinterpret_cast<uint32_t*>(xa + row * R + e % R) =
        pack_bf16(__fmul_rn(scale, v0), __fmul_rn(scale, v1));
  }
  __syncthreads();
  // pass 2: the same bytes of x, the last read first, quantized with their
  // row's scale
  auto quantized = [](const uint4& v, float s) {
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j / 4] |= (uint32_t)(quant(__bfloat162float(e[j]), s) & 0xff) << (8 * (j % 4));
    return make_uint2(w[0], w[1]);
  };
  const float s_row[2] = {srow[g], srow[8 + g]};
  for (int i0 = mine - 1; i0 >= 0; i0 -= U2) {
    uint4 xv[U2][2];
#pragma unroll
    for (int u = 0; u < U2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xv[u][h] = i0 - u >= 0 && live[h] ? ld(xr[h] + (warp + PW * (i0 - u)) * 32) : zero;
#pragma unroll
    for (int u = 0; u < U2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (i0 - u >= 0 && live[h])
          *reinterpret_cast<uint2*>(xq + (row0 + 8 * h + g) * K + (warp + PW * (i0 - u)) * 32 +
                                    8 * t) = quantized(xv[u][h], s_row[h]);
  }
}

template <int NT>
int launch_prep(const bf16* x, const bf16* la, int8_t* xq, float* sx, bf16* xa, int m, int k,
                float scale, cudaStream_t stream) {
  lora_prep_kernel<NT><<<(m + 15) / 16, PW * 32, 0, stream>>>(x, la, xq, sx, xa, m, k, scale);
  return (int)cudaGetLastError();
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
  static constexpr bool LORA = false;
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

// K5: K4's sums and scaling with the low-rank step (gemm_sm90.cuh): y =
// bf16((acc * s_x) * s_w) widened to fp32 (the plain version's rounding
// point), then + xa . lora_b^T on the tensor cores, rounded to bf16 once.
struct S8ScaledLoRA {
  using Acc = int;
  static constexpr int ELEM = 1;
  static constexpr bool LORA = true;
  struct Params {
    CUtensorMap txa;  // xa (M, r) bf16, boxes of row_bytes x 128 rows
    CUtensorMap tlb;  // lora_b (N, r) bf16, boxes of row_bytes x 256 rows
    const float* sx;
    const float* sw;
    int ksteps;     // ceil(r / 16): the k16 steps that reach a nonzero column
    int row_bytes;  // 32, 64 or 128 bytes (16, 32 or 64 columns) for r up to 16, 32 or 64
  };
  using Rows = S8Scaled::Rows;
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db, int sd) {
    S8Scaled::mma(d, da, db, sd);
  }
  static __device__ __forceinline__ Rows rows(const Params& p, int row, int m) {
    return S8Scaled::rows({p.sx, p.sw}, row, m);
  }
  static __device__ __forceinline__ void lora_y(const Params& p, const Rows& r,
                                                const int (&d)[128], int j, int col, int n,
                                                float (&y)[128]) {
    const float w0 = col < n ? p.sw[col] : 0.f, w1 = col + 1 < n ? p.sw[col + 1] : 0.f;
    y[4 * j] = __bfloat162float(S8Scaled::scaled(d[4 * j], r.a, w0));
    y[4 * j + 1] = __bfloat162float(S8Scaled::scaled(d[4 * j + 1], r.a, w1));
    y[4 * j + 2] = __bfloat162float(S8Scaled::scaled(d[4 * j + 2], r.b, w0));
    y[4 * j + 3] = __bfloat162float(S8Scaled::scaled(d[4 * j + 3], r.b, w1));
  }
};

// K6: bf16 x bf16 -> f32, rounded to bf16.
struct Bf16Plain {
  using Acc = float;
  static constexpr int ELEM = 2;
  static constexpr bool LORA = false;
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

// K5: out (m, n) bf16 = K4's product + xa . lb^T with xa = bf16(scale * x .
// la^T): one pass writes xq (m, k) int8, sx (m,) fp32 (K4's quantization)
// and xa (m, r) bf16, then the s8 mainloop with the low-rank step.
extern "C" int sam3_int8_lora_gemm(const void* x, void* xq, void* sx, void* xa, const void* wq,
                                   const void* ws, const void* la, const void* lb, void* out,
                                   int m, int n, int k, int r, float scale, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 || n % 8 || r <= 0 || r % 8 || r > MAX_RANK)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* lap = static_cast<const bf16*>(la);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(sx);
  bf16* xap = static_cast<bf16*>(xa);
  int err;
  switch (r / 8) {
    case 1: err = launch_prep<1>(xp, lap, q, sp, xap, m, k, scale, st); break;
    case 2: err = launch_prep<2>(xp, lap, q, sp, xap, m, k, scale, st); break;
    case 3: err = launch_prep<3>(xp, lap, q, sp, xap, m, k, scale, st); break;
    case 4: err = launch_prep<4>(xp, lap, q, sp, xap, m, k, scale, st); break;
    case 5: err = launch_prep<5>(xp, lap, q, sp, xap, m, k, scale, st); break;
    case 6: err = launch_prep<6>(xp, lap, q, sp, xap, m, k, scale, st); break;
    case 7: err = launch_prep<7>(xp, lap, q, sp, xap, m, k, scale, st); break;
    default: err = launch_prep<8>(xp, lap, q, sp, xap, m, k, scale, st); break;
  }
  if (err) return err;
  S8ScaledLoRA::Params p{};
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(ws);
  p.ksteps = (r + 15) / 16;
  p.row_bytes = r <= 16 ? 32 : r <= 32 ? 64 : 128;  // the boxes: 16, 32 or 64 columns
  err = (int)sm90::bind_primary_context();  // the maps are encoded here, before launch's
  if (!err) err = sm90::make_map(&p.txa, xa, m, r, 2, sm90::BM, p.row_bytes);
  if (!err) err = sm90::make_map(&p.tlb, lb, n, r, 2, sm90::BN, p.row_bytes);
  if (err) return err;
  return sm90::launch<S8ScaledLoRA>(xq, wq, out, p, m, n, k, st);
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
