// Stage-cost, op-rate and block-sweep probes of the window-attention forward
// for Hopper (sm_90a). They replace the Pallas probes the JAX package used to
// learn where its window kernel's time goes:
//
//   attention_fwd_kernel<64, STAGE, PAIR>
//                       replaces scripts/probe_window_cost.py::run_stage (the
//                       stage ladder k_copy .. k_full_packed), the block
//                       sweep of scripts/probe_dma_floor.py::run (k_copy,
//                       k_full) and the forward candidates of
//                       scripts/probe_packed.py::run (k_copy, k_slice,
//                       k_blockdiag).
//   probe_op_kernel     replaces probe_window_cost.py::vpu_probe: y <- f(y),
//                       many passes over a resident tile.
//
// The ladder is the production forward itself (attention_fwd.cuh) built at
// each Stage: the same CTA (a consumer warpgroup of 64 query rows and a
// producer warp), the same 64-key K/V tiles through the same TMA ring, the
// same wgmma products with fp32 accumulators, one stage more or less per
// rung, so subtraction attributes K1's time. Its FULL rung at one head per
// CTA is the very kernel instance attention_fwd.cu launches without RoPE.
//
// wpc, the work per CTA: with wpc > 1 one CTA walks wpc heads for the same
// query tile through the same body, in place of the TPU's larger VMEM
// blocks; its ring runs on into the next head, and a second Q slot lets the
// next head's Q load while this one's last tiles are in the tensor cores.
//
// PAIR (COPY, QK_PV, FULL): the block-diagonal head-pair form of the TPU's
// 128-lane candidates. One CTA owns 64 query rows of both heads of a pair:
// Q is [q0 | q1] (64 x 128), K and V are block-diagonal [k0 | 0; 0 | k1]
// (128 x 128), the zero blocks a zero tile in shared memory written once a
// CTA. S = Q K^T is a 128-deep contraction in which half the products are
// zeros, and so is O = P V: every zero product is issued as a wgmma, so the
// rows show what the zero products cost on the tensor cores. Each head's
// softmax is the forward's online_softmax.
//
// What bounds them: the rungs do K1's work or less, 4 * L^2 * dh flops and
// 8 * L * dh bytes per head; at L = 576, dh = 64 they sit near the ridge of
// bf16 tensor-core rate over memory rate, and the time above that is issue
// and latency. The op kernel keeps its elements in registers; its bound is
// per functional unit (probes/window_cost.py::OP_MIX): the least instruction
// mix each op's work needs per element, by unit (FP32, 16-bit x2, ALU, MUFU,
// conversions, shuffle, warp reduce), each unit's time at its rate in the
// CUDA C++ Programming Guide's arithmetic-instruction throughput table for
// cc 9.0, and the issue slot (4 warp instructions a clock per SM); the
// largest of these times binds. tests/test_torch_cuda.py reads the kernel's
// SASS against that mix.

#include <algorithm>
#include <type_traits>

#include "attention_fwd.cuh"

namespace sam3 {
namespace {  // beside the forward's instances (one unnamed namespace per source)

// The op-rate probe: y <- f(y), `passes` times, over (rows, 576) rows held
// in registers. Its design follows the SASS of each op's pass:
//
// - Two rows a warp (OP_RW), 18 elements of each a lane (fp32, at columns
//   j * 32 + lane) or 9 bf16x2 pairs (at columns 2 * (j * 32 + lane)): two
//   independent chains per element slot, so that the MUFU's latency
//   (HMUL2 -> MUFU -> HADD2) and maxreduce's reduction are hidden by fewer
//   warps.
// - The pass loop runs op_unroll(OP) passes an iteration and the rest in a
//   tail loop: its counter, compare and branch take under 5% of the issue
//   slots of any op.
// - A persistent grid (op_launch): every SM holds the same number of CTAs
//   (a dynamic shared-memory request caps the CTAs an SM holds, and the
//   grid is that cap times the SMs), each CTA the same number of warps,
//   sized so that the row pairs an SM holds cover the SM's share of the
//   rows in one round, with no second, partial wave. At 9216 rows on 132
//   SMs: 5 CTAs of 7 warps an SM, 70 row slots against 69.8 rows.
// - maxreduce: the in-thread max is a tree of independent pairs (17 FMNMX),
//   and the warp's max two independent REDUX on the float's bits (warp_max),
//   in place of 5 SHFL and 5 FMNMX, with no integer map of the bits before
//   or after; y + m * 1e-9 in two roundings, as the JAX body and the plain
//   version compute it.
// - add_bf16 takes its addend as an argument: with the addend in a register
//   the compiler splits the adds between HADD2 and HFMA2.MMA, which issue to
//   two pipes, where an immediate addend keeps them all on HADD2's (half
//   the 16-bit rate).
// - fast_exp2 (attention_fwd.cuh) is rounded with FADDs, not FRND and F2I.
enum Op { ADD_F32 = 0, MUL_F32, EXP_F32, EXP2_F32, FEXP2_F32, MAXREDUCE_F32, ADD_BF16, EXP_BF16 };
constexpr int OP_COLS = 576;
constexpr int OP_RW = 2;           // rows a warp, interleaved
constexpr int OP_MAX_WARPS = 7;    // warps a CTA
constexpr int OP_MIN_CTAS = 5;     // CTAs an SM the registers must allow (56 a thread)

__host__ __device__ constexpr bool op_bf16(int op) { return op == ADD_BF16 || op == EXP_BF16; }

// Passes an iteration of the main pass loop: a few hundred instructions an
// iteration, so that the loop's 3 control instructions stay under 5% of
// the issue slots (add bf16: 8 x 18 HADD2 a warp).
__host__ __device__ constexpr int op_unroll(int op) {
  return op == ADD_BF16 ? 8 : (op == ADD_F32 || op == MUL_F32 || op == MAXREDUCE_F32) ? 4 : 2;
}

// The max of v[LO, LO + N) by a tree of independent pairs: N - 1 FMNMX of
// depth ceil(log2 N).
template <int LO, int N, int M>
__device__ __forceinline__ float tree_max(const float (&v)[M]) {
  if constexpr (N == 1) return v[LO];
  else return fmaxf(tree_max<LO, N / 2>(v), tree_max<LO + N / 2, N - N / 2>(v));
}

// The warp's max of m from two REDUX on its bits, with no map of them: as
// signed integers the bits of floats >= +0 order as the floats do, so the
// signed max is the warp's max wherever some lane's m is >= +0; as unsigned
// integers the bits of negative floats order as their magnitudes, so where
// every lane's m is negative the unsigned min is the warp's max. In either
// case the other result is no larger as a float (the least float >= +0, or
// the most negative), so the max of the two as floats is the warp's max.
__device__ __forceinline__ float warp_max(float m) {
  const unsigned i = __float_as_uint(m);
  const int hi = __reduce_max_sync(0xffffffffu, static_cast<int>(i));
  const unsigned lo = __reduce_min_sync(0xffffffffu, i);
  return fmaxf(__int_as_float(hi), __uint_as_float(lo));
}

// One pass over a warp's rows.
template <int OP, int E>
__device__ __forceinline__ void op_pass(float (&r)[OP_RW][E]) {
  if constexpr (OP == MAXREDUCE_F32) {
    float add[OP_RW];
#pragma unroll
    for (int w = 0; w < OP_RW; ++w) add[w] = __fmul_rn(warp_max(tree_max<0, E>(r[w])), 1e-9f);
#pragma unroll
    for (int w = 0; w < OP_RW; ++w)
#pragma unroll
      for (int j = 0; j < E; ++j) r[w][j] = __fadd_rn(r[w][j], add[w]);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
#pragma unroll
      for (int w = 0; w < OP_RW; ++w) {
        float& v = r[w][j];
        if constexpr (OP == ADD_F32) v = v + 1e-7f;
        else if constexpr (OP == MUL_F32) v = v * 1.0000001f;
        else if constexpr (OP == EXP_F32) v = expf(-v) + 0.5f;
        else if constexpr (OP == EXP2_F32) v = exp2f(-v) + 0.5f;
        else v = fast_exp2(-v) + 0.5f;
      }
  }
}

template <int OP, int E>
__device__ __forceinline__ void op_pass(__nv_bfloat162 (&r)[OP_RW][E], __nv_bfloat162 c) {
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f), nl2e = __float2bfloat162_rn(-LOG2E);
#pragma unroll
  for (int j = 0; j < E; ++j)
#pragma unroll
    for (int w = 0; w < OP_RW; ++w) {
      if constexpr (OP == ADD_BF16) r[w][j] = __hadd2(r[w][j], c);
      else r[w][j] = __hadd2(as_bf162(ex2_bf16x2(as_u32(__hmul2(r[w][j], nl2e)))), half);
    }
}

// `c` is add_bf16's addend, bf16(1e-3) in both halves (unused by the others).
template <int OP>
__global__ void __launch_bounds__(OP_MAX_WARPS * 32, OP_MIN_CTAS)
probe_op_kernel(const void* __restrict__ x, void* __restrict__ y, int rows, int passes,
                __nv_bfloat162 c) {
  using T = std::conditional_t<op_bf16(OP), __nv_bfloat162, float>;
  constexpr int W = OP_COLS / (op_bf16(OP) ? 2 : 1);  // T a row
  constexpr int E = W / 32;                           // T a lane
  constexpr int U = op_unroll(OP);
  const int lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int pairs = (rows + OP_RW - 1) / OP_RW;
  for (int g = blockIdx.x * nw + threadIdx.x / 32; g < pairs; g += gridDim.x * nw) {
    const T* src = static_cast<const T*>(x) + (long long)g * OP_RW * W + lane;
    T* dst = static_cast<T*>(y) + (long long)g * OP_RW * W + lane;
    T r[OP_RW][E];
#pragma unroll
    for (int w = 0; w < OP_RW; ++w)
#pragma unroll
      for (int j = 0; j < E; ++j) r[w][j] = g * OP_RW + w < rows ? src[w * W + j * 32] : T{};
    int i = 0;
#pragma unroll 1
    for (; i + U <= passes; i += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if constexpr (op_bf16(OP)) op_pass<OP>(r, c);
        else op_pass<OP>(r);
      }
    }
#pragma unroll 1
    for (; i < passes; ++i) {
      if constexpr (op_bf16(OP)) op_pass<OP>(r, c);
      else op_pass<OP>(r);
    }
#pragma unroll
    for (int w = 0; w < OP_RW; ++w)
      if (g * OP_RW + w < rows)
#pragma unroll
        for (int j = 0; j < E; ++j) dst[w * W + j * 32] = r[w][j];
  }
}

// The launch of the op kernel for `rows` rows: out = {grid, warps a CTA,
// dynamic shared bytes, CTAs an SM}. Every SM gets `ctas` CTAs of `warps`
// warps, the fewest CTAs (of at most OP_MAX_WARPS warps) whose row pairs
// cover ceil(pairs / SMs), so no partial wave: the shared-memory request
// lets no SM hold more, and the grid fills them all. Where an SM cannot
// hold that many at once, full CTAs at the kernel's occupancy, and the warps
// take their row pairs in rounds.
template <int OP>
cudaError_t op_launch(int rows, int* out) {
  auto kernel = probe_op_kernel<OP>;
  int dev, sms, smem_sm, reserved;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (!err) err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (!err) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_sm - reserved);
  if (!err) err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (err) return err;
  const int pairs = (rows + OP_RW - 1) / OP_RW, per_sm = std::max(1, (pairs + sms - 1) / sms);
  int ctas = (per_sm + OP_MAX_WARPS - 1) / OP_MAX_WARPS, warps = (per_sm + ctas - 1) / ctas;
  int smem = (smem_sm / ctas - reserved) / 128 * 128, fit = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, warps * 32, smem);
  if (!err && fit != ctas) {
    warps = OP_MAX_WARPS, smem = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, warps * 32, smem);
  }
  if (err) return err;
  out[0] = std::min(ctas * sms, (pairs + warps - 1) / warps);
  out[1] = warps, out[2] = smem, out[3] = ctas;
  return cudaSuccess;
}

// The last layout worked out, by device and rows, so that a timed launch
// pays no occupancy queries.
template <int OP>
cudaError_t launch_op(const void* x, void* y, int rows, int passes, cudaStream_t stream) {
  static int last_dev = -1, last_rows = -1, cfg[4];
  if (rows <= 0) return cudaSuccess;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev != last_dev || rows != last_rows) {
    if ((err = op_launch<OP>(rows, cfg))) return err;
    last_dev = dev, last_rows = rows;
  }
  probe_op_kernel<OP><<<cfg[0], cfg[1] * 32, cfg[2], stream>>>(x, y, rows, passes,
                                                               __float2bfloat162_rn(1e-3f));
  return cudaGetLastError();
}

}  // namespace
}  // namespace sam3

using namespace sam3;

// C entry points, bound with ctypes; each returns the cudaError_t of its
// launch (0 = success; a refused TMA map: 100000 plus its CUresult).
//
// sam3_probe_stage: the rung `stage` (a Stage) over q, k and v, each
// described by 8 numbers of `maps` (3 x 8, attention_sm90.cuh::make_map4) of
// an (n, p, l, 64) bf16 view; o is an (n, p, l, 64) view with (n, p, l)
// strides `so`. With `pair` (p must be 2) the block-diagonal pair form. Each
// CTA walks `wpc` heads (pairs), which must divide n * p (n).
extern "C" int sam3_probe_stage(const void* q, const void* k, const void* v, void* o, int n,
                                int l, int p, const long long* so, const long long* maps,
                                int stage, int pair, int wpc, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int units = pair ? n : n * p;
  if (wpc < 1 || units % wpc || (pair && p != 2)) return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  FwdArgs a;
  const int err = fwd_setup(m, a, q, k, v, o, nullptr, l, p, units, 64, wpc, so, maps, scale);
  if (err) return err;
  if (pair) {
#define SAM3_PAIR(S) launch_fwd<64, S, true>(m, a, st)
    switch (stage) {
      case COPY: return SAM3_PAIR(COPY);
      case QK_PV: return SAM3_PAIR(QK_PV);
      case FULL: return SAM3_PAIR(FULL);
      default: return (int)cudaErrorInvalidValue;
    }
#undef SAM3_PAIR
  }
#define SAM3_STAGE(S) launch_fwd<64, S, false>(m, a, st)
  switch (stage) {
    case COPY: return SAM3_STAGE(COPY);
    case QK_PV: return SAM3_STAGE(QK_PV);
    case QK_EXP: return SAM3_STAGE(QK_EXP);
    case QK_EXP2: return SAM3_STAGE(QK_EXP2);
    case QK_FEXP: return SAM3_STAGE(QK_FEXP);
    case QK_MEXP: return SAM3_STAGE(QK_MEXP);
    case FULL: return SAM3_STAGE(FULL);
    case FULL_FEXP: return SAM3_STAGE(FULL_FEXP);
    case FULL_BF16S: return SAM3_STAGE(FULL_BF16S);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SAM3_STAGE
}

#define SAM3_OPS(F) \
  F(ADD_F32) F(MUL_F32) F(EXP_F32) F(EXP2_F32) F(FEXP2_F32) F(MAXREDUCE_F32) F(ADD_BF16) F(EXP_BF16)

// sam3_probe_op: x and y are contiguous (rows, 576) fp32 (ops 0-5) or bf16
// (ops 6-7); y = f applied `passes` times to x.
extern "C" int sam3_probe_op(const void* x, void* y, int rows, int op, int passes,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
#define SAM3_CASE(OP) case OP: return launch_op<OP>(x, y, rows, passes, st);
    SAM3_OPS(SAM3_CASE)
#undef SAM3_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// sam3_probe_op_layout: how op `op` runs `rows` rows on the current device:
// out = {passes an iteration of the main pass loop, rows a warp, grid, warps
// a CTA, dynamic shared bytes, CTAs an SM}.
extern "C" int sam3_probe_op_layout(int op, int rows, int* out) {
  out[0] = op_unroll(op), out[1] = OP_RW;
  switch (op) {
#define SAM3_CASE(OP) case OP: return op_launch<OP>(rows, out + 2);
    SAM3_OPS(SAM3_CASE)
#undef SAM3_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
#undef SAM3_OPS
