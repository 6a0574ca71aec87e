// The multi-head attention forward for Hopper (sm_90a), templated on a
// stage: the production forward (attention_fwd.cu, STAGE = FULL) and the
// rungs of the window-kernel probes (probe_window.cu) are one body, so the
// rungs differ from the production kernel by exactly the stages they leave
// out or change, and subtraction attributes its time. The design is
// described at the top of attention_fwd.cu.
//
// The stages:
//
//   COPY        o = q: the TMA ring's loads of q, k and v, q stored back
//   QK_PV       o = bf16(S * scale) V                  (tensor-core issue)
//   QK_EXP      o = exp(S * scale) V                   (+ expf)
//   QK_EXP2     o = exp2(S * scale * log2 e) V         (+ ex2)
//   QK_FEXP     o = fast_exp2(S * scale * log2 e) V    (+ an fp32 polynomial)
//   QK_MEXP     o = exp(S * scale - rowmax) V          (+ online max, rescale)
//   FULL        the normalized softmax: the production forward
//   FULL_FEXP   FULL with fast_exp2 for every exponential
//   FULL_BF16S  FULL with the scores rounded to bf16 and scaled, shifted and
//               exponentiated in packed bf16x2 (ex2.approx.ftz.bf16x2)
//
// PAIR builds the block-diagonal head-pair form of the probes: one unit of
// work is both heads of a pair, Q is [q0 | q1] (64 x 128) and K, V are
// block-diagonal [k0 | 0; 0 | k1], so S and PV are 128-deep contractions in
// which half the products are zeros; the zero blocks are a zero tile in
// shared memory, written once a CTA, and every zero product is issued.

#pragma once

#include "attention_sm90.cuh"

namespace sam3 {

enum Stage {
  COPY = 0, QK_PV, QK_EXP, QK_EXP2, QK_FEXP, QK_MEXP, FULL, FULL_FEXP, FULL_BF16S,
};

// The rungs whose softmax rescales the output (a running max).
__host__ __device__ constexpr bool rescales(int stage) { return stage >= QK_MEXP; }

// 2^x as the JAX probe writes it (scripts/probe_window_cost.py::fast_exp2):
// xi = clip(rint(x), -126, 127), a degree-4 polynomial on f = x - xi, and
// 2^xi put in by bits; lowered with full-rate instructions only. x is
// clamped first (rint of the clamped value is the clamp of rint(x)), then
// rounded by adding 1.5 * 2^23: on [-126, 127] the sum s lies in [2^23,
// 2^24), where the spacing is 1, so the addition rounds to the nearest
// integer, ties to even, and xi = s - 1.5 * 2^23 is exact (__fadd_rn: the
// two additions are never folded).
// s's bits are 0x4b400000 + xi, so (s's bits << 23) + (127 << 23) is
// (xi + 127) << 23 modulo 2^32, one shift-add. No FRND or F2I (the
// conversion rate, 16 a clock per SM), and bit for bit the value of
// clip(rintf(x)) for every x (NaN included: fmaxf takes -126).
__device__ __forceinline__ float fast_exp2(float x) {
  constexpr float ROUND = 12582912.f;  // 1.5 * 2^23
  const float s = __fadd_rn(fminf(fmaxf(x, -126.f), 127.f), ROUND);
  const float xi = __fadd_rn(s, -ROUND);
  const float f = x - xi;
  const float p = 1.f + f * (0.6931471805599453f +
                             f * (0.2402265069591007f +
                                  f * (0.05550410866482158f + f * 0.009618129107628477f)));
  return p * __uint_as_float((__float_as_uint(s) << 23) + (127u << 23));
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

// 2^x on the approximate unit (relative error ~2^-22; results below 2^-126
// flush to 0, where P rounds to 0 in bf16 anyway)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One K/V tile of the exact online softmax on a warpgroup's accumulators
// (attention_sm90.cuh: s[4j + 2r + e] at row g + 8r, key 8j + 2t + e). The
// scores (kv_valid keys valid; the rest, TMA's zero rows, masked to -inf)
// are scaled to log2 units by sl2 (a positive factor, so the row max is
// taken on the raw scores and the scale folds into the exponent's
// multiply-add) and shifted by the running row max m_run; this thread's
// row-sum shares l_run are rescaled and alpha says by how much the output
// must be (rescale); P, rounded to bf16, lands in pf as the register A
// fragments of the 4 k16 steps over the tile's keys. FEXP takes fast_exp2
// for every exponential.
template <bool FEXP>
__device__ __forceinline__ void online_softmax(float (&s)[32], uint32_t (&pf)[4][4],
                                               float (&m_run)[2], float (&l_run)[2],
                                               float (&alpha)[2], int kv_valid, float sl2,
                                               int t) {
  if (kv_valid < TILE) {  // a ragged last tile
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * 8 + t * 2 + (e & 1) >= kv_valid) s[4 * j + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float nm[2];  // -(the new row max), log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * sl2);
    if constexpr (FEXP)  // fast_exp2(-inf) is not 0
      alpha[r] = m_run[r] == -INFINITY ? 0.f : fast_exp2(m_run[r] - m_new);
    else
      alpha[r] = ex2_approx(m_run[r] - m_new);  // 0 on the first tile
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
    nm[r] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* x = s + 4 * j;
    float p0, p1, p2, p3;
    if constexpr (FEXP) {
      p0 = x[0] == -INFINITY ? 0.f : fast_exp2(fmaf(x[0], sl2, nm[0]));
      p1 = x[1] == -INFINITY ? 0.f : fast_exp2(fmaf(x[1], sl2, nm[0]));
      p2 = x[2] == -INFINITY ? 0.f : fast_exp2(fmaf(x[2], sl2, nm[1]));
      p3 = x[3] == -INFINITY ? 0.f : fast_exp2(fmaf(x[3], sl2, nm[1]));
    } else {
      p0 = ex2_approx(fmaf(x[0], sl2, nm[0])), p1 = ex2_approx(fmaf(x[1], sl2, nm[0]));
      p2 = ex2_approx(fmaf(x[2], sl2, nm[1])), p3 = ex2_approx(fmaf(x[3], sl2, nm[1]));
    }
    l_run[0] += p0 + p1;
    l_run[1] += p2 + p3;
    pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
    pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
}

// The output's two rows of this thread (acc[4j + 2r + e], row g + 8r) times
// alpha[r].
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

// Keep the compiler from reusing or moving register A fragments while a
// wgmma that reads them may be in flight (see fence_regs in sm90.cuh).
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j])::"memory");
}

// The stage's P of one 64 x 64 score tile s, as the register A fragments pf
// of PV, and (rescales(STAGE)) the output's rescale alpha (see
// online_softmax for the arguments).
template <int STAGE>
__device__ __forceinline__ void scores_to_p(float (&s)[32], uint32_t (&pf)[4][4],
                                            float (&m_run)[2], float (&l_run)[2],
                                            float (&alpha)[2], int kv_valid, float scale, int t) {
  const float sl2 = scale * LOG2E;  // exp(x) = exp2(x * log2 e)
  if constexpr (STAGE <= QK_FEXP) {
    // no max, no sum: TMA's zero rows of a ragged K/V tile meet zero V rows
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[4 * j + i];
        if constexpr (STAGE == QK_PV) e[i] = x * scale;
        else if constexpr (STAGE == QK_EXP) e[i] = expf(x * scale);
        else if constexpr (STAGE == QK_EXP2) e[i] = exp2f(x * sl2);
        else e[i] = fast_exp2(x * sl2);
      }
      pf[j / 2][(j & 1) * 2] = pack_bf16(e[0], e[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(e[2], e[3]);
    }
  } else if constexpr (STAGE == FULL_BF16S) {
    // scores rounded to bf16, then scaled, shifted and exponentiated in
    // packed bf16x2; row max and row sum of the bf16 values
    const __nv_bfloat162 sc2 = __float2bfloat162_rn(scale);
    const __nv_bfloat162 l2e2 = __float2bfloat162_rn(LOG2E);
    __nv_bfloat162 sb[8][2];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + t * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __nv_bfloat162 x = __hmul2(__floats2bfloat162_rn(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]), sc2);
        if (col >= kv_valid) x.x = __float2bfloat16(-INFINITY);
        if (col + 1 >= kv_valid) x.y = __float2bfloat16(-INFINITY);
        sb[j][r] = x;
        mx[r] = fmaxf(mx[r], fmaxf(__bfloat162float(x.x), __bfloat162float(x.y)));
      }
    }
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
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t e = ex2_bf16x2(as_u32(__hmul2(__hsub2(sb[j][r], m2[r]), l2e2)));
        const float2 ef = __bfloat1622float2(as_bf162(e));
        l_run[r] += ef.x + ef.y;
        pf[j / 2][(j & 1) * 2 + r] = e;
      }
    }
  } else {  // QK_MEXP, FULL, FULL_FEXP: the online softmax
    online_softmax<STAGE == FULL_FEXP>(s, pf, m_run, l_run, alpha, kv_valid, sl2, t);
  }
}

// This thread's two output rows (row0 + g and row0 + g + 8) of one head, the
// stage's normalization applied, as bf16 into o (row stride sl) where the
// row is < L; with FULL and lse, each row's natural log-sum-exp of the
// scaled scores, ln(2^m * l), into lse (indexed by row).
template <int DH, int STAGE>
__device__ __forceinline__ void store_o(const float (&acc)[DH / 2], const float (&m_run)[2],
                                        float (&l_run)[2], bf16* o, long long sl,
                                        float* lse, int row0, int L, int g, int t) {
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
    const int row = row0 + g + r * 8;
    if (row >= L) continue;
    const float inv = NORMALIZED ? 1.f / l_run[r] : 1.f;
    bf16* dst = o + (long long)row * sl + t * 2;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if constexpr (STAGE == FULL)
      if (lse != nullptr && t == 0) lse[row] = (m_run[r] + log2f(l_run[r])) * LN2;
  }
}

namespace {  // internal linkage: each source that includes this has its own instances

// What the main kernel takes besides its three tensor maps (q or its
// rotation, k or its rotation, v). `slots`: per map, which of its
// dimensions 1..3 is the row, head and sequence (attention_sm90.cuh).
struct FwdArgs {
  bf16* o;     // (N, P, L, DH) output view, strides so
  float* lse;  // (N, P, L) fp32 log-sum-exp, or null
  Strides so;
  int L, P;
  int units;  // heads (head pairs with PAIR)
  int wpc;    // units a CTA walks, one after the other
  float scale;
  int slots[3];
};

// The CTA's shape and dynamic shared memory, tiles 1024-byte aligned from
// the aligned base: Q slots (two when a CTA walks several units, so the
// ring runs ahead into the next one), the K ring, the V ring, the pair
// form's zero tile, the barriers (q full, q empty, 2 each; ring full, ring
// empty).
template <int DH, bool PAIR>
struct FwdShape {
  static constexpr int NH = PAIR ? 2 : 1;      // heads a unit of work
  static constexpr int THREADS = 128 + 32;     // a consumer warpgroup, a producer warp
  static constexpr int PRODUCER = 4;           // the producer's warp
  static constexpr int STAGES = PAIR ? 2 : 3;  // ring depth
  static constexpr int BYTES = Tile<DH>::BYTES;
  static constexpr int UNIT = NH * BYTES;  // a Q slot; the K (V) tiles of one stage
  static __host__ __device__ int qslots(int wpc) { return wpc > 1 ? 2 : 1; }
  static __host__ __device__ int k_off(int qs) { return qs * UNIT; }
  static __host__ __device__ int v_off(int qs) { return k_off(qs) + STAGES * UNIT; }
  static __host__ __device__ int zero_off(int qs) { return v_off(qs) + STAGES * UNIT; }
  static __host__ __device__ int bar_off(int qs) { return zero_off(qs) + (PAIR ? BYTES : 0); }
  static __host__ __device__ int total(int qs) { return bar_off(qs) + (4 + 2 * STAGES) * 8 + 1024; }
};

// The forward's body. A CTA owns 64 query rows (blockIdx.x) of a.wpc heads
// (head pairs with PAIR) in turn: one consumer warpgroup and one producer
// warp. The producer brings each head's Q tile by TMA into a Q slot, then
// streams its 64-key (K, V) tiles through a ring of STAGES stages, each
// with a full and an empty mbarrier. Per tile the warpgroup runs wgmma S =
// Q K^T (A and B K-major in shared memory) into fp32 registers, the stage's
// softmax on the accumulators, and wgmma O += P V with P, rounded to bf16,
// as a register A operand and V read MN-major; a warp releases the stage
// once PV has retired. Three CTAs share an SM, so one CTA's softmax runs
// while another's products do.
template <int DH, int STAGE, bool PAIR>
__global__ void __launch_bounds__(FwdShape<DH, PAIR>::THREADS, PAIR ? 1 : 3)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using namespace sm90;
  using T = Tile<DH>;
  using S = FwdShape<DH, PAIR>;
  constexpr int NH = S::NH, STAGES = S::STAGES;
  constexpr int KS = DH / 16;  // k16 steps of S per head
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = cvta_smem(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int qs = S::qslots(a.wpc);
  const uint32_t q_s = base, k_s = base + S::k_off(qs), v_s = base + S::v_off(qs);
  const uint32_t zero_s = base + S::zero_off(qs), bars = base + S::bar_off(qs);
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (2 + i); };
  auto full = [&](int s) { return bars + 8 * (4 + s); };
  auto empty = [&](int s) { return bars + 8 * (4 + STAGES + s); };

  const int q0 = blockIdx.x * TILE;
  const int tiles = (a.L + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int last = min(a.wpc, a.units - (int)blockIdx.y * a.wpc);  // units of this CTA

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);           // the producer's expect_tx; TMA completes the bytes
      mbar_init(q_empty(i), 4);          // one arrival per consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    mbar_fence_init();
  }
  if constexpr (PAIR) {  // the zero blocks, before the ring starts
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (zero_s - raw));
    for (int i = threadIdx.x; i < T::BYTES / 16; i += S::THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_async_smem();  // visible to wgmma's reads
  }
  __syncthreads();

  if (warp == S::PRODUCER) {
    if (lane == 0) {
      int c = 0;  // ring steps so far, across units
      for (int w = 0; w < last; ++w) {
        const int unit = blockIdx.y * a.wpc + w;
        const int n = PAIR ? unit : unit / a.P, p = PAIR ? 0 : unit % a.P;
        const int slot = w % qs;
        mbar_wait(q_empty(slot), ((w / qs) & 1) ^ 1);
        mbar_expect_tx(q_full(slot), NH * T::BYTES);
        for (int h = 0; h < NH; ++h)  // rows past L: TMA's zero fill
          load_rows(q_s + slot * S::UNIT + h * T::BYTES, &tq, a.slots[0], q_full(slot), q0,
                    p + h, n);
        for (int i = 0; i < tiles; ++i, ++c) {
          const int s = c % STAGES;
          mbar_wait(empty(s), ((c / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * NH * T::BYTES);
          for (int h = 0; h < NH; ++h) {
            load_rows(k_s + s * S::UNIT + h * T::BYTES, &tk, a.slots[1], full(s), TILE * i, p + h, n);
            load_rows(v_s + s * S::UNIT + h * T::BYTES, &tv, a.slots[2], full(s), TILE * i, p + h, n);
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows are row0 + g (+ 8)
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp;
  int c = 0;
  for (int w = 0; w < last; ++w) {
    const int unit = blockIdx.y * a.wpc + w;
    const int n = PAIR ? unit : unit / a.P, p = PAIR ? 0 : unit % a.P;
    const int slot = w % qs;
    const uint32_t qt = q_s + slot * S::UNIT;
    mbar_wait(q_full(slot), (w / qs) & 1);
    float m_run[NH][2], l_run[NH][2], acc[NH][DH / 2];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      m_run[h][0] = m_run[h][1] = -INFINITY;  // log2 units
      l_run[h][0] = l_run[h][1] = 0.f;        // this thread's share of the row sums
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[h][i] = 0.f;
    }
    for (int i = 0; i < tiles; ++i, ++c) {
      const int s = c % STAGES;
      mbar_wait(full(s), (c / STAGES) & 1);
      if constexpr (STAGE == COPY) {
        if (lane == 0) mbar_arrive(empty(s));
      } else {
        const uint32_t kt = k_s + s * S::UNIT, vt = v_s + s * S::UNIT;
        // S = Q K^T per head: with PAIR, k16 steps 0..KS-1 run over q0's
        // dims and KS.. over q1's, against head h's K or the zero tile
        float sc[NH][32];
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int kk = 0; kk < NH * KS; ++kk) {
            const uint32_t kb = kk / KS == h ? kt + h * T::BYTES : zero_s;
            wgmma_ss_n64(sc[h], T::kmajor(qt + (kk / KS) * T::BYTES) + (kk % KS) * T::KSTEP,
                         T::kmajor(kb) + (kk % KS) * T::KSTEP, kk);
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < NH; ++h) fence_regs(sc[h]);

        uint32_t pf[NH][4][4];
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          float alpha[2];
          scores_to_p<STAGE>(sc[h], pf[h], m_run[h], l_run[h], alpha, a.L - TILE * i, a.scale,
                             t);
          if constexpr (rescales(STAGE)) rescale(acc[h], alpha);
        }
        // O += P V: with PAIR, k16 steps 0-3 are head 0's keys, 4-7 head 1's.
        // The rescaled O and P are pinned before wgmma.fence, which orders
        // register writes before the wgmma that reads them.
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          fence_regs(acc[h]);
          fence_frags(pf[h]);
        }
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int kk = 0; kk < NH * 4; ++kk) {
            const uint32_t vb = kk / 4 == h ? vt + h * T::BYTES : zero_s;
            wgmma_rs<DH>(acc[h], pf[kk / 4][kk % 4], T::mnmajor(vb) + (kk % 4) * T::MNSTEP);
          }
        wgmma_commit();
        // PV retires before the loop goes on: no wgmma is in flight across
        // an iteration, so nothing the compiler moves there can race one
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          fence_regs(acc[h]);
          fence_frags(pf[h]);
        }
        if (lane == 0) mbar_arrive(empty(s));
      }
    }
    if constexpr (STAGE == COPY) {
      // q stored back from its slot, chunk by chunk through the swizzle
      constexpr int CPR = DH / 8;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const unsigned char* tile = smem_raw + (qt + h * T::BYTES - raw);
        bf16* dst = a.o + a.so.at(n, p + h);
        for (int i = threadIdx.x; i < TILE * CPR; i += 128) {
          const int r = i / CPR, cc = i % CPR;
          if (q0 + r < a.L)
            *reinterpret_cast<uint4*>(dst + (long long)(q0 + r) * a.so.l + cc * 8) =
                *reinterpret_cast<const uint4*>(tile + T::chunk(r, cc));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty(slot));
    } else {
      if (lane == 0) mbar_arrive(q_empty(slot));  // S's last reads of Q have retired
      float* lse = PAIR || a.lse == nullptr ? nullptr : a.lse + (long long)unit * a.L;
#pragma unroll
      for (int h = 0; h < NH; ++h)
        store_o<DH, STAGE>(acc[h], m_run[h], l_run[h], a.o + a.so.at(n, p + h), a.so.l, lse,
                           row0, a.L, g, t);
    }
  }
}

// The rotation pass: one warp per (sequence, row), q and k of every head
// rotated into contiguous (N, P, L, DH) scratch (attention_sm90.cuh::
// rotate_row).
template <int DH>
__global__ void __launch_bounds__(128)
rope_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, bf16* __restrict__ qr,
            bf16* __restrict__ kr, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, int N, int L, int P, Strides sq, Strides sk) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= (long long)N * L) return;  // uniform across the warp
  rotate_row<DH>(q, k, qr, kr, cos_t, sin_t, row / L, (int)(row % L), L, P, sq, sk,
                 threadIdx.x % 32);
}

// ---- host side

// The three maps of the main kernel (`maps`: 3 x 8 numbers from
// ops/attention_kernel.py::fwd_maps, over the pointers q, k, v) and its
// arguments. 0, or the first error (MAP_REFUSED plus a CUresult for a
// refused map).
inline int fwd_setup(CUtensorMap (&m)[3], FwdArgs& a, const void* q, const void* k, const void* v,
                     void* o, void* lse, int l, int p, int units, int dh, int wpc,
                     const long long* so, const long long* maps, float scale) {
  const cudaError_t bound = sm90::bind_primary_context();
  if (bound != cudaSuccess) return (int)bound;
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = make_map4(&m[i], srcs[i], dh, maps + 8 * i);
    if (err) return err;
    a.slots[i] = (int)maps[8 * i + 6];
  }
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.so = {so[0], so[1], so[2]};
  a.L = l;
  a.P = p;
  a.units = units;
  a.wpc = wpc;
  a.scale = scale;
  return 0;
}

// a.units heads (pairs), a.wpc of them a CTA, ceil(L / 64) CTAs a unit.
template <int DH, int STAGE, bool PAIR>
cudaError_t launch_fwd(const CUtensorMap (&m)[3], const FwdArgs& a, cudaStream_t stream) {
  using S = FwdShape<DH, PAIR>;
  auto kern = attention_fwd_kernel<DH, STAGE, PAIR>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::total(2));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.L + TILE - 1) / TILE, (a.units + a.wpc - 1) / a.wpc);
  kern<<<grid, S::THREADS, S::total(S::qslots(a.wpc)), stream>>>(m[0], m[1], m[2], a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_rope(const void* q, const void* k, void* qr, void* kr, const float* cos_t,
                        const float* sin_t, int n, int l, int p, const long long* s,
                        cudaStream_t stream) {
  const long long rows = (long long)n * l;
  rope_kernel<DH><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(qr),
      static_cast<bf16*>(kr), cos_t, sin_t, n, l, p, {s[0], s[1], s[2]}, {s[3], s[4], s[5]});
  return cudaGetLastError();
}

}  // namespace
}  // namespace sam3
