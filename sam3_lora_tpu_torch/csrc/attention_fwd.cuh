// The multi-head attention forward kernel for Hopper (sm_90a), templated on a
// stage: the production forward (attention_fwd.cu, STAGE = FULL) and the
// rungs of the window-kernel probes (probe_window.cu) are one body, so the
// rungs differ from the production kernel by exactly the stages they leave
// out or change, and subtraction attributes its time. The design is
// described at the top of attention_fwd.cu.
//
// The stages:
//
//   COPY        o = q; q, k and v are loaded as the forward loads them
//   QK_PV       o = bf16(S * scale) V                  (tensor-core issue)
//   QK_EXP      o = exp(S * scale) V                   (+ expf)
//   QK_EXP2     o = exp2(S * scale * log2 e) V         (+ ex2)
//   QK_FEXP     o = fast_exp2(S * scale * log2 e) V    (+ an fp32 polynomial)
//   QK_MEXP     o = exp(S * scale - rowmax) V          (+ online max, rescale)
//   FULL        the normalized softmax: the production forward
//   FULL_FEXP   FULL with fast_exp2 for every exponential
//   FULL_BF16S  FULL with the scores rounded to bf16 and scaled, shifted and
//               exponentiated in packed bf16x2 (ex2.approx.ftz.bf16x2)

#pragma once

#include "attention_common.cuh"

namespace sam3 {

enum Stage {
  COPY = 0, QK_PV, QK_EXP, QK_EXP2, QK_FEXP, QK_MEXP, FULL, FULL_FEXP, FULL_BF16S,
};

// 2^x as the JAX probe writes it (scripts/probe_window_cost.py::fast_exp2):
// round, a degree-4 polynomial on the fraction, the exponent put in by bits.
__device__ __forceinline__ float fast_exp2(float x) {
  const float xi = fminf(fmaxf(rintf(x), -126.f), 127.f);
  const float f = x - xi;
  const float p = 1.f + f * (0.6931471805599453f +
                             f * (0.2402265069591007f +
                                  f * (0.05550410866482158f + f * 0.009618129107628477f)));
  return p * __int_as_float((static_cast<int>(xi) + 127) << 23);
}

__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// One K/V tile of the exact online softmax on a warp's accumulators. The NT
// n8 score tiles s (kv_valid keys valid) are scaled to log2 units by sl2 and
// shifted by the running row max m_run (rows g and g + 8); the OT output
// tiles acc and this thread's row-sum shares l_run are rescaled; P, rounded
// to bf16, lands in pf as the A fragments of NT / 2 k16 steps. FEXP takes
// fast_exp2 for every exponential.
template <int NT, int OT, bool FEXP>
__device__ __forceinline__ void online_softmax(float (*s)[4], float (*acc)[4], uint32_t (*pf)[4],
                                               float (&m_run)[2], float (&l_run)[2],
                                               int kv_valid, float sl2, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + t * 2 + (e & 1);
      const float x = col < kv_valid ? s[j][e] * sl2 : -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    if constexpr (FEXP)  // fast_exp2(-inf) is not 0
      alpha[r] = m_run[r] == -INFINITY ? 0.f : fast_exp2(m_run[r] - m_new);
    else
      alpha[r] = exp2f(m_run[r] - m_new);  // 0 on the first tile
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float p0, p1, p2, p3;
    if constexpr (FEXP) {
      const float* x = s[j];
      p0 = x[0] == -INFINITY ? 0.f : fast_exp2(x[0] - m_run[0]);
      p1 = x[1] == -INFINITY ? 0.f : fast_exp2(x[1] - m_run[0]);
      p2 = x[2] == -INFINITY ? 0.f : fast_exp2(x[2] - m_run[1]);
      p3 = x[3] == -INFINITY ? 0.f : fast_exp2(x[3] - m_run[1]);
    } else {
      p0 = exp2f(s[j][0] - m_run[0]), p1 = exp2f(s[j][1] - m_run[0]);
      p2 = exp2f(s[j][2] - m_run[1]), p3 = exp2f(s[j][3] - m_run[1]);
    }
    l_run[0] += p0 + p1;
    l_run[1] += p2 + p3;
    pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
    pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
}

// Write `rows_valid` rows of DH bf16 from a shared tile to o.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, const bf16* src,
                                           int rows_valid) {
  constexpr int CPR = DH / 8, LDH = Layout<DH>::LDH;
  for (int i = threadIdx.x; i < 64 * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    if (r < rows_valid)
      *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(src + r * LDH + c);
  }
}

namespace {  // internal linkage: each source that includes this has its own instances

// One 64-row query tile (rows q0..) of head `head` (sequence head / P, head
// head % P): the forward's body. One block of 4 warps; each warp holds its 16
// query rows as mma.sync A fragments, streams 64-key K/V tiles through shared
// memory, computes S = QK^T with m16n8k16 bf16 mma.sync into fp32, runs the
// stage's softmax on the accumulators and feeds P, rounded to bf16, straight
// back as the A operand of PV. With lse (FULL only), each row's natural
// log-sum-exp of the scaled scores.
template <int DH, bool ROPE, int STAGE>
__device__ __forceinline__ void attention_fwd_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int L, int P, int head, int q0, Strides sq, Strides sk,
    Strides sv, Strides so, float scale) {
  using Lay = Layout<DH>;
  constexpr int LDH = Lay::LDH;
  constexpr int KS = DH / 16;  // k16 steps over the head dim
  constexpr int NT = BK / 8;   // n8 tiles of scores per K tile
  constexpr int OT = DH / 8;   // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + Lay::tile;
  bf16* Vs = Ks + Lay::tile;

  const long long n = head / P;
  const int p = head % P;
  const bf16* kb = k + sk.at(n, p);
  const bf16* vb = v + sv.at(n, p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair

  load_tile<DH, ROPE>(Qs, q + sq.at(n, p) + (long long)q0 * sq.l, sq.l,
                      min(BQ, L - q0), cos_t, sin_t, q0);
  __syncthreads();
  uint32_t qf[KS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a(qf[kk], Qs + warp * 16 * LDH + kk * 16, LDH);

  const float sl2 = scale * LOG2E;  // exp(x) = exp2(x * log2 e)
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    const int kv_valid = min(BK, L - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DH, ROPE>(Ks, kb + (long long)k0 * sk.l, sk.l, kv_valid, cos_t, sin_t, k0);
    load_tile<DH, false>(Vs, vb + (long long)k0 * sv.l, sv.l, kv_valid, nullptr, nullptr, 0);
    __syncthreads();
    if constexpr (STAGE != COPY) {
      // S = Q K^T: 16 rows x 64 keys per warp, fp32 in registers
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];  // keys j*8.. (b[0], b[1]) and j*8+8.. (b[2], b[3])
          load_b_nk(b, Ks + j * 8 * LDH + kk * 16, LDH);
          mma(s[j], qf[kk], b[0], b[1]);
          mma(s[j + 1], qf[kk], b[2], b[3]);
        }
      }

      uint32_t pf[BK / 16][4];  // P as A fragments, one per 16-key step
      if constexpr (STAGE <= QK_FEXP) {
        // no max, no sum: the zero rows of a ragged K/V tile meet zero V rows
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float e[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (STAGE == QK_PV) e[i] = s[j][i] * scale;
            else if constexpr (STAGE == QK_EXP) e[i] = expf(s[j][i] * scale);
            else if constexpr (STAGE == QK_EXP2) e[i] = exp2f(s[j][i] * sl2);
            else e[i] = fast_exp2(s[j][i] * sl2);
          }
          pf[j / 2][(j & 1) * 2] = pack_bf16(e[0], e[1]);
          pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(e[2], e[3]);
        }
      } else if constexpr (STAGE == FULL_BF16S) {
        // scores rounded to bf16, then scaled, shifted and exponentiated in
        // packed bf16x2; row max and row sum of the bf16 values
        const __nv_bfloat162 sc2 = __float2bfloat162_rn(scale);
        const __nv_bfloat162 l2e2 = __float2bfloat162_rn(LOG2E);
        __nv_bfloat162 sb[NT][2];
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = j * 8 + t * 2;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            __nv_bfloat162 x = __hmul2(__floats2bfloat162_rn(s[j][2 * r], s[j][2 * r + 1]), sc2);
            if (col >= kv_valid) x.x = __float2bfloat16(-INFINITY);
            if (col + 1 >= kv_valid) x.y = __float2bfloat16(-INFINITY);
            sb[j][r] = x;
            mx[r] = fmaxf(mx[r], fmaxf(__bfloat162float(x.x), __bfloat162float(x.y)));
          }
        }
        float alpha[2];
        __nv_bfloat162 m2[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);  // a bf16 value
          alpha[r] = expf(m_run[r] - m_new);
          m_run[r] = m_new;
          l_run[r] *= alpha[r];
          m2[r] = __float2bfloat162_rn(m_new);
        }
#pragma unroll
        for (int j = 0; j < OT; ++j) {
          acc[j][0] *= alpha[0];
          acc[j][1] *= alpha[0];
          acc[j][2] *= alpha[1];
          acc[j][3] *= alpha[1];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t e = ex2_bf16x2(as_u32(__hmul2(__hsub2(sb[j][r], m2[r]), l2e2)));
            const float2 ef = __bfloat1622float2(as_bf162(e));
            l_run[r] += ef.x + ef.y;
            pf[j / 2][(j & 1) * 2 + r] = e;
          }
        }
      } else {  // QK_MEXP, FULL, FULL_FEXP: the online softmax
        online_softmax<NT, OT, STAGE == FULL_FEXP>(s, acc, pf, m_run, l_run, kv_valid, sl2, t);
      }

      // O += P V
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < OT; j += 2) {
          uint32_t b[4];  // dims j*8.. (b[0], b[1]) and j*8+8.. (b[2], b[3])
          load_b_kn(b, Vs + kk * 16 * LDH + j * 8, LDH);
          mma(acc[j], pf[kk], b[0], b[1]);
          mma(acc[j + 1], pf[kk], b[2], b[3]);
        }
      }
    }
  }

  if constexpr (STAGE == COPY) {
    store_rows<DH>(o + so.at(n, p) + (long long)q0 * so.l, so.l, Qs, min(BQ, L - q0));
  } else {
    constexpr bool NORMALIZED = STAGE >= FULL;
    if constexpr (NORMALIZED) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + r * 8;
      if (row >= L) continue;
      const float inv = NORMALIZED ? 1.f / l_run[r] : 1.f;
      bf16* dst = o + so.at(n, p) + (long long)row * so.l + t * 2;
#pragma unroll
      for (int j = 0; j < OT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(acc[j][r * 2] * inv, acc[j][r * 2 + 1] * inv);
      // natural log-sum-exp of the scaled scores: ln(2^m * l)
      if constexpr (STAGE == FULL)
        if (lse != nullptr && t == 0)
          lse[(long long)head * L + row] = (m_run[r] + log2f(l_run[r])) * LN2;
    }
  }
}

// One block per (64-row query tile, head): grid (ceil(L / 64), N * P).
template <int DH, bool ROPE, int STAGE>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ cos_t,
                     const float* __restrict__ sin_t, int L, int P, Strides sq,
                     Strides sk, Strides sv, Strides so, float scale) {
  attention_fwd_tile<DH, ROPE, STAGE>(q, k, v, o, lse, cos_t, sin_t, L, P, blockIdx.y,
                                      blockIdx.x * BQ, sq, sk, sv, so, scale);
}

template <int DH, bool ROPE, int STAGE>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const float* cos_t, const float* sin_t, int n, int l, int p,
                       Strides sq, Strides sk, Strides sv, Strides so, float scale,
                       cudaStream_t stream) {
  constexpr int bytes = 3 * Layout<DH>::tile * sizeof(bf16);  // Q, K, V
  auto kern = attention_fwd_kernel<DH, ROPE, STAGE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((l + BQ - 1) / BQ, n * p);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, cos_t, sin_t, l, p,
      sq, sk, sv, so, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sam3
