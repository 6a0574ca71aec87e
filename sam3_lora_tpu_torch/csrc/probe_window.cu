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
// and latency. The op kernel keeps its elements in registers and is bound by
// the issue rate of its instructions (the CUDA C++ Programming Guide's
// arithmetic-instruction throughput table).

#include "attention_fwd.cuh"

namespace sam3 {
namespace {  // beside the forward's instances (one unnamed namespace per source)

// The op-rate probe: each warp holds one 576-wide row, 18 elements a lane
// (fp32, at columns j * 32 + lane) or 9 bf16x2 pairs (at columns
// 2 * (j * 32 + lane)), and applies y <- f(y) `passes` times in registers.
enum Op { ADD_F32 = 0, MUL_F32, EXP_F32, EXP2_F32, FEXP2_F32, MAXREDUCE_F32, ADD_BF16, EXP_BF16 };
constexpr int OP_COLS = 576;

template <int OP>
__global__ void __launch_bounds__(THREADS)
probe_op_kernel(const void* __restrict__ x, void* __restrict__ y, int rows, int passes) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  if constexpr (OP == ADD_BF16 || OP == EXP_BF16) {
    constexpr int E = OP_COLS / 64;
    const __nv_bfloat162* src = static_cast<const __nv_bfloat162*>(x) + (long long)row * OP_COLS / 2;
    __nv_bfloat162* dst = static_cast<__nv_bfloat162*>(y) + (long long)row * OP_COLS / 2;
    __nv_bfloat162 r[E];
#pragma unroll
    for (int j = 0; j < E; ++j) r[j] = src[j * 32 + lane];
    const __nv_bfloat162 c1 = __float2bfloat162_rn(1e-3f), half = __float2bfloat162_rn(0.5f);
    const __nv_bfloat162 nl2e = __float2bfloat162_rn(-LOG2E);
    for (int i = 0; i < passes; ++i) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if constexpr (OP == ADD_BF16) r[j] = __hadd2(r[j], c1);
        else r[j] = __hadd2(as_bf162(ex2_bf16x2(as_u32(__hmul2(r[j], nl2e)))), half);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) dst[j * 32 + lane] = r[j];
  } else {
    constexpr int E = OP_COLS / 32;
    const float* src = static_cast<const float*>(x) + (long long)row * OP_COLS;
    float* dst = static_cast<float*>(y) + (long long)row * OP_COLS;
    float r[E];
#pragma unroll
    for (int j = 0; j < E; ++j) r[j] = src[j * 32 + lane];
    for (int i = 0; i < passes; ++i) {
      if constexpr (OP == MAXREDUCE_F32) {
        float m = r[0];
#pragma unroll
        for (int j = 1; j < E; ++j) m = fmaxf(m, r[j]);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
        const float add = m * 1e-9f;
#pragma unroll
        for (int j = 0; j < E; ++j) r[j] = r[j] + add;
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if constexpr (OP == ADD_F32) r[j] = r[j] + 1e-7f;
          else if constexpr (OP == MUL_F32) r[j] = r[j] * 1.0000001f;
          else if constexpr (OP == EXP_F32) r[j] = expf(-r[j]) + 0.5f;
          else if constexpr (OP == EXP2_F32) r[j] = exp2f(-r[j]) + 0.5f;
          else r[j] = fast_exp2(-r[j]) + 0.5f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) dst[j * 32 + lane] = r[j];
  }
}

template <int OP>
cudaError_t launch_op(const void* x, void* y, int rows, int passes, cudaStream_t stream) {
  probe_op_kernel<OP><<<(rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(x, y, rows, passes);
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

// sam3_probe_op: x and y are contiguous (rows, 576) fp32 (ops 0-5) or bf16
// (ops 6-7); y = f applied `passes` times to x.
extern "C" int sam3_probe_op(const void* x, void* y, int rows, int op, int passes,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case ADD_F32: return launch_op<ADD_F32>(x, y, rows, passes, st);
    case MUL_F32: return launch_op<MUL_F32>(x, y, rows, passes, st);
    case EXP_F32: return launch_op<EXP_F32>(x, y, rows, passes, st);
    case EXP2_F32: return launch_op<EXP2_F32>(x, y, rows, passes, st);
    case FEXP2_F32: return launch_op<FEXP2_F32>(x, y, rows, passes, st);
    case MAXREDUCE_F32: return launch_op<MAXREDUCE_F32>(x, y, rows, passes, st);
    case ADD_BF16: return launch_op<ADD_BF16>(x, y, rows, passes, st);
    case EXP_BF16: return launch_op<EXP_BF16>(x, y, rows, passes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
