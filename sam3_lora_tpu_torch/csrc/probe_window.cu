// Stage-cost, op-rate and block-sweep probes of the window-attention forward
// for Hopper (sm_90a). They replace the Pallas probes the JAX package used to
// learn where its window kernel's time goes:
//
//   attention_fwd_kernel<64, false, STAGE>, probe_sweep_kernel, probe_pair_kernel
//                       replace scripts/probe_window_cost.py::run_stage (the
//                       stage ladder k_copy .. k_full_packed), the block
//                       sweep of scripts/probe_dma_floor.py::run (k_copy,
//                       k_full) and the forward candidates of
//                       scripts/probe_packed.py::run (k_copy, k_slice,
//                       k_blockdiag).
//   probe_op_kernel     replaces probe_window_cost.py::vpu_probe: y <- f(y),
//                       many passes over a resident tile.
//
// The ladder is the production forward itself (attention_fwd.cuh) built at
// each Stage: the same CTA (4 warps, 64 query rows, 16 per warp), the same
// 64-key K/V tiles through shared memory (load_tile), the same ldmatrix
// fragments and m16n8k16 bf16 mma.sync with fp32 accumulators, one stage
// more or less per rung, so subtraction attributes K1's time. Its FULL rung
// is the very kernel instance attention_fwd.cu launches without RoPE.
//
// wpc, the work per CTA: with wpc > 1 one CTA of probe_sweep_kernel walks wpc
// heads for the same query tile through the same body, in place of the TPU's
// larger VMEM blocks.
//
// PAIR (COPY, QK_PV, FULL): the block-diagonal head-pair form of the TPU's
// 128-lane candidates. One CTA owns 64 query rows of both heads of a pair:
// Q is [q0 | q1] (64 x 128), K and V are block-diagonal [k0 | 0; 0 | k1]
// (128 x 128), the zero blocks as zero fragments in registers. S = Q K^T is
// a 128-deep contraction in which half the products are zeros, and so is
// O = P V: the rows show what the zero products cost on the tensor cores.
// Each head's softmax is the forward's online_softmax.
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

// wpc heads per CTA, one after the other, each through the forward's body.
template <int STAGE>
__global__ void __launch_bounds__(THREADS)
probe_sweep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int L, int P, int wpc,
                   Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  for (int w = 0; w < wpc; ++w) {
    __syncthreads();  // the previous head is done with the shared tiles
    attention_fwd_tile<64, false, STAGE>(q, k, v, o, nullptr, nullptr, nullptr, L, P,
                                         blockIdx.y * wpc + w, blockIdx.x * BQ, sq, sk, sv,
                                         so, scale);
  }
}

// The block-diagonal head-pair form: one pair (p = 0, 1 of sequence n) per
// step of the wpc loop (see the top of the file). Each head's Q, K and V
// tile lies in shared memory as K1 loads it; the zero blocks of the
// block-diagonal K and V are zero B fragments in registers, so every zero
// product is issued as an mma and none is read from memory.
template <int STAGE>
__global__ void __launch_bounds__(THREADS)
probe_pair_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int L, int wpc,
                  Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  constexpr int DH = 64;
  using Lay = Layout<DH>;
  constexpr int LDH = Lay::LDH;
  constexpr int T = Lay::tile;
  constexpr int KS = 2 * DH / 16;  // k16 steps of S: the 128-deep contraction
  constexpr int NT = 2 * BK / 8;   // n8 tiles of scores: 64 keys of each head
  constexpr int OT = 2 * DH / 8;   // n8 tiles of the output, both heads
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // head h at Qs + h * T
  bf16* Ks = Qs + 2 * T;
  bf16* Vs = Ks + 2 * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, L - q0);

  for (int w = 0; w < wpc; ++w) {
    const long long n = (long long)blockIdx.y * wpc + w;
    __syncthreads();
    for (int h = 0; h < 2; ++h)
      load_tile<DH, false>(Qs + h * T, q + sq.at(n, h) + (long long)q0 * sq.l, sq.l, q_valid,
                           nullptr, nullptr, 0);
    __syncthreads();
    uint32_t qf[KS][4];  // [q0 | q1]: k16 steps 0-3 of head 0, 4-7 of head 1
    if constexpr (STAGE != COPY) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        load_a(qf[kk], Qs + (kk / 4) * T + warp * 16 * LDH + (kk % 4) * 16, LDH);
    }
    const float sl2 = scale * LOG2E;
    float m_run[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};  // [head][row]
    float l_run[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float acc[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int k0 = 0; k0 < L; k0 += BK) {
      const int kv_valid = min(BK, L - k0);
      __syncthreads();
      for (int h = 0; h < 2; ++h) {
        load_tile<DH, false>(Ks + h * T, k + sk.at(n, h) + (long long)k0 * sk.l, sk.l, kv_valid,
                             nullptr, nullptr, 0);
        load_tile<DH, false>(Vs + h * T, v + sv.at(n, h) + (long long)k0 * sv.l, sv.l, kv_valid,
                             nullptr, nullptr, 0);
      }
      __syncthreads();
      if constexpr (STAGE != COPY) {
        float s[NT][4];  // keys 0-63 of head 0, then of head 1
#pragma unroll
        for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t b[4] = {0u, 0u, 0u, 0u};  // an off-diagonal block: zeros
            if (kk / 4 == j / 8) load_b_nk(b, Ks + (j / 8) * T + (j % 8) * 8 * LDH + (kk % 4) * 16, LDH);
            mma(s[j], qf[kk], b[0], b[1]);
            mma(s[j + 1], qf[kk], b[2], b[3]);
          }
        }
        uint32_t pf[NT / 2][4];
        if constexpr (STAGE == QK_PV) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            pf[j / 2][(j & 1) * 2] = pack_bf16(s[j][0] * scale, s[j][1] * scale);
            pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(s[j][2] * scale, s[j][3] * scale);
          }
        } else {  // FULL
#pragma unroll
          for (int h = 0; h < 2; ++h)  // keys, outputs and P fragments of head h
            online_softmax<NT / 2, OT / 2, false>(s + h * NT / 2, acc + h * OT / 2,
                                                  pf + h * NT / 4, m_run[h], l_run[h],
                                                  kv_valid, sl2, t);
        }
        // O += P V over the 128 keys of both heads: 128 deep, half zeros
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
          for (int j = 0; j < OT; j += 2) {
            uint32_t b[4] = {0u, 0u, 0u, 0u};
            if (kk / 4 == j / 8) load_b_kn(b, Vs + (kk / 4) * T + (kk % 4) * 16 * LDH + (j % 8) * 8, LDH);
            mma(acc[j], pf[kk], b[0], b[1]);
            mma(acc[j + 1], pf[kk], b[2], b[3]);
          }
        }
      }
    }

    if constexpr (STAGE == COPY) {
      for (int h = 0; h < 2; ++h)
        store_rows<DH>(o + so.at(n, h) + (long long)q0 * so.l, so.l, Qs + h * T, q_valid);
    } else {
      if constexpr (STAGE == FULL) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l_run[h][r] += __shfl_xor_sync(0xffffffffu, l_run[h][r], 1);
            l_run[h][r] += __shfl_xor_sync(0xffffffffu, l_run[h][r], 2);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + r * 8;
        if (row >= L) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float inv = STAGE == FULL ? 1.f / l_run[h][r] : 1.f;
          bf16* dst = o + so.at(n, h) + (long long)row * so.l + t * 2;
#pragma unroll
          for (int j = 0; j < OT / 2; ++j) {
            const float* a = acc[h * OT / 2 + j];
            *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
                __floats2bfloat162_rn(a[r * 2] * inv, a[r * 2 + 1] * inv);
          }
        }
      }
    }
  }
}

// One head per CTA: the forward kernel itself at STAGE; more: the sweep kernel.
template <int STAGE>
cudaError_t launch_one(const void* q, const void* k, const void* v, void* o, int n, int l,
                       int p, int wpc, Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, cudaStream_t stream) {
  if (wpc == 1)
    return launch_fwd<64, false, STAGE>(q, k, v, o, nullptr, nullptr, nullptr, n, l, p, sq, sk,
                                        sv, so, scale, stream);
  constexpr int bytes = 3 * Layout<64>::tile * sizeof(bf16);
  auto kern = probe_sweep_kernel<STAGE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((l + BQ - 1) / BQ, n * p / wpc);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), l, p, wpc, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

template <int STAGE>
cudaError_t launch_pair(const void* q, const void* k, const void* v, void* o, int n, int l,
                        int wpc, Strides sq, Strides sk, Strides sv, Strides so, float scale,
                        cudaStream_t stream) {
  constexpr int bytes = 6 * Layout<64>::tile * sizeof(bf16);  // Q, K, V of two heads
  auto kern = probe_pair_kernel<STAGE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((l + BQ - 1) / BQ, n / wpc);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), l, wpc, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

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
// launch (0 = success).
//
// sam3_probe_stage: q, k, v and o are (n, p, l, 64) bf16 views given by their
// (n, p, l) strides in elements (`strides`: 4 x 3) with a contiguous last dim.
// `stage` is a Stage; with `pair` (p must be 2) the block-diagonal pair form.
// Each CTA walks `wpc` heads (pairs), which must divide n * p (n).
extern "C" int sam3_probe_stage(const void* q, const void* k, const void* v, void* o, int n,
                                int l, int p, const long long* strides, int stage, int pair,
                                int wpc, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* z = strides;
  const Strides sq{z[0], z[1], z[2]}, sk{z[3], z[4], z[5]}, sv{z[6], z[7], z[8]},
      so{z[9], z[10], z[11]};
  if (wpc < 1) return (int)cudaErrorInvalidValue;
  if (pair) {
    if (p != 2 || n % wpc) return (int)cudaErrorInvalidValue;
#define SAM3_PAIR(S) launch_pair<S>(q, k, v, o, n, l, wpc, sq, sk, sv, so, scale, st)
    switch (stage) {
      case COPY: return SAM3_PAIR(COPY);
      case QK_PV: return SAM3_PAIR(QK_PV);
      case FULL: return SAM3_PAIR(FULL);
      default: return (int)cudaErrorInvalidValue;
    }
#undef SAM3_PAIR
  }
  if ((n * p) % wpc) return (int)cudaErrorInvalidValue;
#define SAM3_STAGE(S) launch_one<S>(q, k, v, o, n, l, p, wpc, sq, sk, sv, so, scale, st)
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
