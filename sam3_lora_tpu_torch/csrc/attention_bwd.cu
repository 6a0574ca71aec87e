// Packed multi-head attention backward for Hopper (sm_90a): dQ, dK, dV of the
// forward in attention_fwd.cu, one source for every training-path entry:
//
//   window_attention_rope_packed  replaces sam3_lora_tpu/ops/window_attention.py
//   (K1), window_attention_packed _bwd_kernel_rope_packed (:445) and
//   (K1'), the grouped and pair  _bwd_kernel_packed (:426), and the backward
//   routes (W-g, W-p)             calls of _window_pallas (:507) and
//                                 _window_pallas_packed (:584): 576-token
//                                 windows, 16 heads x 64.
//   long_attention_rope_packed    replace sam3_lora_tpu/ops/long_attention.py
//   long_attention_packed         _make_bwd_kernel (:218, pallas_call :367):
//   (K2, K3)                      the 4 global ViT blocks (5184 tokens,
//                                 16 x 64) and the 6 fusion-encoder
//                                 self-attentions (5184 tokens, 8 x 32).
//   window_attention_qkv (W-qkv)  replaces sam3_lora_tpu/ops/window_qkv.py
//                                 _call_bwd (:208, pallas_call :228).
//
// It computes the standard attention backward, FlashAttention-2 style, from
// q, k, v, the saved output O, dO and the forward's fp32 row log-sum-exp:
//
//   P  = exp(Q K^T * scale - LSE)         recomputed tile by tile
//   D  = rowsum(dO o O)                   fp32
//   dV = P^T dO,  dS = P o (dO V^T - D)
//   dQ = dS K * scale,  dK = dS^T Q * scale
//
// Three kernels, no atomics (each output element is written once, by one
// CTA, so two runs give the same bits):
//   * bwd_prep_kernel: one warp per (sequence, row): D, lse in log2 units
//     (both padded to whole 64-row tiles: +inf and 0 past L, so padded
//     query rows get P = 0), and with RoPE q and k rotated once into
//     contiguous (N, P, L, dh) scratch (attention_sm90.cuh::rotate_row, the
//     forward's rotation pass). The main kernels then rotate nothing;
//     without RoPE they read q and k in place through their strided views.
//   * dkdv_kernel: a CTA owns 64 keys of one head: one consumer warpgroup
//     and one producer warp. K and V come in once by TMA; the producer streams
//     (Q tile, dO tile, the tile's lse and D) for each 64-query tile through
//     a ring of STAGES stages (a full and an empty mbarrier each). Per stage
//     the consumers run wgmma S^T = K Q^T and dP^T = V dO^T (A and B
//     K-major in shared memory), forms P^T and dS^T in registers, packs them
//     to bf16 as register A operands (the accumulator fragment of an m64n16
//     slice is the A fragment of one k16 step) and run dV += P^T dO and
//     dK += dS^T Q, with the same Q and dO stage read MN-major (wgmma's
//     transpose flag). A stage is released once the group that read it has
//     retired (after the next stage's S^T/dP^T wait), so the two groups of
//     consecutive tiles queue back to back.
//   * dq_kernel: a CTA owns 64 queries; Q, dO (TMA) and their lse, D
//     (registers) are loaded once, K and V tiles stream through the ring:
//     S = Q K^T, dP = dO V^T, dS in registers (keys past L masked to P = 0),
//     dQ += dS K with K read MN-major.
// Epilogues scale dQ and dK, rotate them back with the transpose of the
// rotation (they are the gradients of the unrotated inputs), round to bf16
// and store rows < L straight from registers into the strided output views,
// so the three gradients of a packed qkv land in one (N, L, 3*P*dh) buffer.
// TMA zero-fills rows past L (the maps' L dimension is the sequence's own).
//
// What bounds it on the H100: tensor-core operations. The two passes form S
// and dP twice, so a head costs 7 products of 2 * L^2 * dh (the 5-product
// count of measure.attention_work times 1.4) at 989 TFLOP/s; the bytes (q,
// k, v, o, dO, dq, dk, dv once, 1/39 of the time at L = 576) never bind.
// The design feeds the tensor cores from a TMA ring without register
// staging, keeps P and dS in registers, and rotates with RoPE once.
//
// Tile: 64-row CTAs of 5 warps, 3 stages. L = 576 is 9 x 64 and 5184 is
// 81 x 64, so no warpgroup idles on a window's last tile, and two (at dh 64:
// dkdv 166 registers, dq 144) or three (dh 32: 126, 125) CTAs share an SM,
// so one CTA's loads, exponentials and epilogue overlap another's products. Within a CTA the
// exponentials of a tile run while its dP^T (dP) product is in the tensor
// cores, and dS^T while dV is. Measured on the card and not kept: 128-row
// CTAs of two warpgroups sharing each stage (one CTA an SM), 2 or 4 stages,
// and K, V (Q, dO) held as register A operands (spills). No setmaxnreg: it
// takes whole warpgroups, and a producer warpgroup would cost more
// registers than its one warp.

#include "attention_sm90.cuh"

namespace {

using namespace sam3;
using namespace sam3::sm90;

constexpr int STAGES = 3;
constexpr int CTA_THREADS = 128 + 32;  // a consumer warpgroup and a producer warp
constexpr int PRODUCER = 4;        // the producer's warp

// CTAs an SM: three at DH = 32 (at most 136 registers a thread, no spills),
// two at 64 (at most 204; 136 would spill dkdv's 128 accumulator values)
template <int DH>
constexpr int min_blocks() {
  return DH == 32 ? 3 : 2;
}

// 2^x on the approximate unit (relative error ~2^-22; results below 2^-126
// flush to 0, where P rounds to 0 in bf16 anyway)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scale the two accumulator rows of this thread (a wgmma m64nDH fragment:
// acc[4j + 2r + e] at row row0 + g + 8r, column 8j + 2t + e), rotate them
// back with the transpose of the forward's rotate-half RoPE at sequence
// position `row`, and write the rows < L as bf16 into `base` (row stride sl).
template <int DH, bool ROPE>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 2], bf16* base, long long sl,
                                           int row0, int L, float scale,
                                           const float* __restrict__ cos_t,
                                           const float* __restrict__ sin_t) {
  constexpr int OT = DH / 8, H = DH / 2;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= L) continue;
    float x[OT][2];
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      x[j][0] = acc[4 * j + 2 * r] * scale;
      x[j][1] = acc[4 * j + 2 * r + 1] * scale;
    }
    if (ROPE) {
      // forward: (a, b) -> (a c - b s, a s + b c); its transpose:
      // (da, db) -> (da c + db s, -da s + db c)
      const float* cs = cos_t + (long long)row * H;
      const float* sn = sin_t + (long long)row * H;
#pragma unroll
      for (int j = 0; j < OT / 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = j * 8 + t * 2 + e;
          const float c = cs[d], s = sn[d];
          const float a = x[j][e], b = x[j + OT / 2][e];
          x[j][e] = a * c + b * s;
          x[j + OT / 2][e] = b * c - a * s;
        }
      }
    }
    bf16* dst = base + (long long)row * sl + t * 2;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(x[j][0], x[j][1]);
  }
}

// D = rowsum(dO o O) and lse * log2(e) into padded (heads, lpad) fp32
// scratch (0 and +inf for rows L..lpad-1), and with ROPE q, k rotated into
// contiguous (N, P, L, DH) qr, kr. One warp per (n, l) row of the padded
// length; no fused multiply-add anywhere, so the plain version
// (ops/attention_kernel.py::attention_bwd_prep_plain) gives the same bits:
// each lane sums its 8 products in order (a product of two bf16 is exact in
// fp32), then a butterfly over the head's DH / 8 lanes.
template <int DH, bool ROPE>
__global__ void __launch_bounds__(128)
bwd_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, bf16* __restrict__ qr, bf16* __restrict__ kr,
                float* __restrict__ lse2, float* __restrict__ D,
                const float* __restrict__ cos_t, const float* __restrict__ sin_t, int N, int L,
                int lpad, int P, Strides sq, Strides sk, Strides so, Strides sd) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= (long long)N * lpad) return;  // uniform across the warp
  const long long n = row / lpad;
  const int l = (int)(row % lpad);
  const int lane = threadIdx.x % 32;
  if (l >= L) {
    for (int h = lane; h < P; h += 32) {
      lse2[(n * P + h) * lpad + l] = INFINITY;
      D[(n * P + h) * lpad + l] = 0.f;
    }
    return;
  }
  for (int h = lane; h < P; h += 32)
    lse2[(n * P + h) * lpad + l] = __fmul_rn(lse[(n * P + h) * L + l], LOG2E);

  constexpr int G = DH / 8;  // lanes per head (divides 32)
  const bf16* orow = o + so.at(n, 0) + (long long)l * so.l;
  const bf16* drow = dout + sd.at(n, 0) + (long long)l * sd.l;
  for (int c0 = 0; c0 < P * G; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    if (c < P * G) {
      const int h = c / G, d = (c % G) * 8;  // head, first of its 8 elements
      const uint4 a = *reinterpret_cast<const uint4*>(orow + h * so.p + d);
      const uint4 b = *reinterpret_cast<const uint4*>(drow + h * sd.p + d);
      const bf16* pa = reinterpret_cast<const bf16*>(&a);
      const bf16* pb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(pb[j]), __bfloat162float(pa[j])));
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (c < P * G && lane % G == 0) D[(n * P + c / G) * lpad + l] = acc;
  }
  if (!ROPE) return;

  rotate_row<DH>(q, k, qr, kr, cos_t, sin_t, n, l, L, P, sq, sk, lane);
}

// What the main kernels take besides their tensor maps. `slots` says, per
// map (q, k, v, dO), which of its dimensions 1..3 is the row (bits 0-3),
// the head (4-7) and the sequence (8-11): the host orders them by stride.
struct MainArgs {
  const float* lse2;  // (heads, lpad): lse * log2(e), +inf past L
  const float* D;     // (heads, lpad): rowsum(dO o O), 0 past L
  bf16 *dq, *dk, *dv;
  const float *cos_t, *sin_t;
  Strides sdq, sdk, sdv;
  int L, lpad, P;
  float scale;
  int slots[4];
};

template <int DH>
struct Smem {  // dynamic shared memory of either main kernel, 1024-byte aligned tiles
  static constexpr int BYTES = Tile<DH>::BYTES;
  static constexpr int OWN = 2 * BYTES;                  // K, V (dkdv) or Q, dO (dq)
  static constexpr int RING = 2 * STAGES * BYTES;        // Q, dO (dkdv) or K, V (dq)
  static constexpr int ROWS = 2 * STAGES * TILE * 4;     // lse, D per stage (dkdv)
  static constexpr int BARS = (1 + 2 * STAGES) * 8;
  static constexpr int TOTAL = OWN + RING + ROWS + BARS + 1024;
};

template <int DH>
__global__ void __launch_bounds__(CTA_THREADS, min_blocks<DH>())
dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const MainArgs a) {
  using T = Tile<DH>;
  using S = Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (cvta_smem(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + T::BYTES;
  const uint32_t q_s = base + S::OWN, do_s = q_s + STAGES * T::BYTES;
  const uint32_t rows_s = base + S::OWN + S::RING;  // lse, then D, per stage
  const uint32_t bars = rows_s + S::ROWS;
  const float* rows_p = reinterpret_cast<const float*>(smem_raw + (rows_s - cvta_smem(smem_raw)));
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int head = blockIdx.y, p = head % a.P, n = head / a.P;
  const int k0 = blockIdx.x * TILE;
  const int tiles = (a.L + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);            // the producer's expect_tx; TMA completes the bytes
      mbar_init(empty(s), 4);           // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == PRODUCER) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * T::BYTES);
      load_rows(k_s, &tk, a.slots[1], kv_full, k0, p, n);
      load_rows(v_s, &tv, a.slots[2], kv_full, k0, p, n);
      const float* lse_h = a.lse2 + (long long)head * a.lpad;
      const float* d_h = a.D + (long long)head * a.lpad;
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::BYTES + 2 * TILE * 4);
        load_rows(q_s + s * T::BYTES, &tq, a.slots[0], full(s), TILE * i, p, n);
        load_rows(do_s + s * T::BYTES, &tdo, a.slots[3], full(s), TILE * i, p, n);
        bulk_load(rows_s + s * 2 * TILE * 4, lse_h + TILE * i, TILE * 4, full(s));
        bulk_load(rows_s + (s * 2 + 1) * TILE * 4, d_h + TILE * i, TILE * 4, full(s));
      }
    }
    return;
  }

  // the consumer warpgroup
  const int t = lane & 3;
  const uint64_t ka = T::kmajor(k_s), va = T::kmajor(v_s);
  const float sl2 = a.scale * LOG2E;
  float dka[DH / 2], dva[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_full, 0);
  int prev = 0;
  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    const uint32_t qt = q_s + s * T::BYTES, dot = do_s + s * T::BYTES;
    float st[32], dpt[32];  // S^T (then P^T), dP^T: 64 keys x 64 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(st, ka + kk * T::KSTEP, T::kmajor(qt) + kk * T::KSTEP, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(dpt, va + kk * T::KSTEP, T::kmajor(dot) + kk * T::KSTEP, kk);
    wgmma_commit();
    wgmma_wait<1>();  // S^T, and the last tile's dV/dK: its stage is free
    fence_regs(st);
    if (i > 0 && lane == 0) mbar_arrive(empty(prev));

    // P^T = exp2(S^T scale log2e - lse2) per query column 8j + 2t + e, while
    // dP^T is in the tensor cores; packed as the A fragments of dV's k16
    // steps over the 64 queries
    const float* lse_t = rows_p + s * 2 * TILE;
    const float* d_t = lse_t + TILE;
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + j * 8 + t * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * j + e] = exp2_approx(st[4 * j + e] * sl2 - ((e & 1) ? l2.y : l2.x));
      pa[j / 2][(j & 1) * 2] = pack_bf16(st[4 * j], st[4 * j + 1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(dva, pa[kk], T::mnmajor(dot) + kk * T::MNSTEP);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T; dV runs on
    fence_regs(dpt);

    // dS^T = P^T o (dP^T - D), the A fragments of dK's k16 steps
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(d_t + j * 8 + t * 2);
      sa[j / 2][(j & 1) * 2] =
          pack_bf16(st[4 * j] * (dpt[4 * j] - dd.x), st[4 * j + 1] * (dpt[4 * j + 1] - dd.y));
      sa[j / 2][(j & 1) * 2 + 1] =
          pack_bf16(st[4 * j + 2] * (dpt[4 * j + 2] - dd.x), st[4 * j + 3] * (dpt[4 * j + 3] - dd.y));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(dka, sa[kk], T::mnmajor(qt) + kk * T::MNSTEP);
    wgmma_commit();
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(dka);
  fence_regs(dva);

  const int row0 = k0 + 16 * warp;
  bf16* dk = a.dk + a.sdk.at(n, p);
  if (a.cos_t != nullptr)
    store_rows<DH, true>(dka, dk, a.sdk.l, row0, a.L, a.scale, a.cos_t, a.sin_t);
  else
    store_rows<DH, false>(dka, dk, a.sdk.l, row0, a.L, a.scale, nullptr, nullptr);
  store_rows<DH, false>(dva, a.dv + a.sdv.at(n, p), a.sdv.l, row0, a.L, 1.f, nullptr, nullptr);
}

template <int DH>
__global__ void __launch_bounds__(CTA_THREADS, min_blocks<DH>())
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const MainArgs a) {
  using T = Tile<DH>;
  using S = Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (cvta_smem(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + T::BYTES;
  const uint32_t k_s = base + S::OWN, v_s = k_s + STAGES * T::BYTES;
  const uint32_t bars = base + S::OWN + S::RING;
  const uint32_t qo_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int head = blockIdx.y, p = head % a.P, n = head / a.P;
  const int q0 = blockIdx.x * TILE;
  const int tiles = (a.L + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == PRODUCER) {
    if (lane == 0) {
      mbar_expect_tx(qo_full, 2 * T::BYTES);
      load_rows(q_s, &tq, a.slots[0], qo_full, q0, p, n);
      load_rows(do_s, &tdo, a.slots[3], qo_full, q0, p, n);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::BYTES);
        load_rows(k_s + s * T::BYTES, &tk, a.slots[1], full(s), TILE * i, p, n);
        load_rows(v_s + s * T::BYTES, &tv, a.slots[2], full(s), TILE * i, p, n);
      }
    }
    return;
  }

  // the consumer warpgroup; this thread's rows r0 and r0 + 8 (rows past L
  // read the padding: lse2 +inf, so P = 0)
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * warp + g;
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = a.lse2[(long long)head * a.lpad + r0 + 8 * h];
    dd[h] = a.D[(long long)head * a.lpad + r0 + 8 * h];
  }
  const uint64_t qa = T::kmajor(q_s), da = T::kmajor(do_s);
  const float sl2 = a.scale * LOG2E;
  float dqa[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dqa[i] = 0.f;
  mbar_wait(qo_full, 0);
  int prev = 0;
  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    const uint32_t kt = k_s + s * T::BYTES, vt = v_s + s * T::BYTES;
    float sc[32], dp[32];  // S (then P), dP: 64 queries x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(sc, qa + kk * T::KSTEP, T::kmajor(kt) + kk * T::KSTEP, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(dp, da + kk * T::KSTEP, T::kmajor(vt) + kk * T::KSTEP, kk);
    wgmma_commit();
    wgmma_wait<1>();  // S, and the last tile's dQ: its stage is free
    fence_regs(sc);
    if (i > 0 && lane == 0) mbar_arrive(empty(prev));

    // P while dP is in the tensor cores; keys past L masked to P = 0 (their
    // zero-filled K rows would add nothing either)
    const int kv_valid = a.L - TILE * i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        sc[4 * j + e] = col < kv_valid ? exp2_approx(sc[4 * j + e] * sl2 - lse2[e >> 1]) : 0.f;
      }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P o (dP - D), as A fragments over the keys
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sa[j / 2][(j & 1) * 2] =
          pack_bf16(sc[4 * j] * (dp[4 * j] - dd[0]), sc[4 * j + 1] * (dp[4 * j + 1] - dd[0]));
      sa[j / 2][(j & 1) * 2 + 1] =
          pack_bf16(sc[4 * j + 2] * (dp[4 * j + 2] - dd[1]), sc[4 * j + 3] * (dp[4 * j + 3] - dd[1]));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(dqa, sa[kk], T::mnmajor(kt) + kk * T::MNSTEP);
    wgmma_commit();
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(dqa);

  bf16* dq = a.dq + a.sdq.at(n, p);
  const int row0 = q0 + 16 * warp;
  if (a.cos_t != nullptr)
    store_rows<DH, true>(dqa, dq, a.sdq.l, row0, a.L, a.scale, a.cos_t, a.sin_t);
  else
    store_rows<DH, false>(dqa, dq, a.sdq.l, row0, a.L, a.scale, nullptr, nullptr);
}

// ---- host side

template <int DH>
cudaError_t launch_bwd(const CUtensorMap (&m)[4], const MainArgs& a, int heads,
                       cudaStream_t stream) {
  constexpr int smem = Smem<DH>::TOTAL;
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(dq_kernel<DH>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.L + TILE - 1) / TILE, heads);
  dkdv_kernel<DH><<<grid, CTA_THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DH><<<grid, CTA_THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

template <int DH, bool ROPE>
cudaError_t launch_prep(const bf16* q, const bf16* k, const bf16* o, const bf16* dout,
                        const float* lse, bf16* qr, bf16* kr, float* lse2, float* D,
                        const float* cos_t, const float* sin_t, int n, int l, int lpad, int p,
                        const long long* s, cudaStream_t stream) {
  const long long rows = (long long)n * lpad;
  bwd_prep_kernel<DH, ROPE><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      q, k, o, dout, lse, qr, kr, lse2, D, cos_t, sin_t, n, l, lpad, p, {s[0], s[1], s[2]},
      {s[3], s[4], s[5]}, {s[6], s[7], s[8]}, {s[9], s[10], s[11]});
  return cudaGetLastError();
}

int prep(const void* q, const void* k, const void* o, const void* dout, const void* lse, void* qr,
         void* kr, void* scratch, const void* cos_t, const void* sin_t, int n, int l, int p,
         int dh, int lpad, const long long* strides, cudaStream_t st) {
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k);
  const bf16 *o_ = static_cast<const bf16*>(o), *d_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  bf16 *qr_ = static_cast<bf16*>(qr), *kr_ = static_cast<bf16*>(kr);
  float* lse2 = static_cast<float*>(scratch);
  float* D = lse2 + (long long)n * p * lpad;
  const float *c = static_cast<const float*>(cos_t), *s = static_cast<const float*>(sin_t);
  const bool rope = cos_t != nullptr;
#define PREP(DH, R) \
  launch_prep<DH, R>(q_, k_, o_, d_, lse_, qr_, kr_, lse2, D, c, s, n, l, lpad, p, strides, st)
  if (dh == 64) return rope ? PREP(64, true) : PREP(64, false);
  if (dh == 32) return rope ? PREP(32, true) : PREP(32, false);
#undef PREP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points, bound with ctypes; every view is (n, p, l, dh) bf16 with
// a contiguous last dim, given by its (n, p, l) strides in elements.
//
// sam3_attention_bwd_prep: the prep pass alone. From q, k, o, dout
// (`strides`: 4 x 3, in that order) and the forward's (n, p, l) fp32
// log-sum-exp, write `scratch` (2 x (n p) x lpad fp32: lse * log2(e) and D,
// padded to lpad, a multiple of 64) and, when cos_t/sin_t ((l, dh/2) fp32)
// are given, the rotated q, k into contiguous qr, kr.
//
// sam3_attention_bwd: the whole backward, dq, dk, dv (`strides`: 7 x 3 for
// q, k, o, dout, dq, dk, dv): the prep pass into qm, km (the rotated
// scratch with RoPE, else q and k themselves) and `scratch`, then the two
// main kernels, which read qm, km, v and dout by TMA, each described by 7
// numbers of `maps` (4 x 8, see make_map4). With cos_t, dq and dk are rotated back. The maps are
// encoded before the first launch, so the three kernels queue back to back.
// Both return the first cudaError_t that is not 0 (a map cuTensorMapEncodeTiled
// refused: 100000 plus its CUresult), or 0.
extern "C" int sam3_attention_bwd_prep(const void* q, const void* k, const void* o,
                                       const void* dout, const void* lse, void* qr, void* kr,
                                       void* scratch, const void* cos_t, const void* sin_t, int n,
                                       int l, int p, int dh, int lpad, const long long* strides,
                                       void* stream) {
  return prep(q, k, o, dout, lse, qr, kr, scratch, cos_t, sin_t, n, l, p, dh, lpad, strides,
              static_cast<cudaStream_t>(stream));
}

extern "C" int sam3_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* qm, void* km,
                                  void* scratch, void* dq, void* dk, void* dv, const void* cos_t,
                                  const void* sin_t, int n, int l, int p, int dh, int lpad,
                                  const long long* strides, const long long* maps,
                                  float scale, void* stream) {
  if (dh != 64 && dh != 32) return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  const void* srcs[4] = {qm, km, v, dout};
  MainArgs a;
  const cudaError_t bound = bind_primary_context();
  if (bound != cudaSuccess) return (int)bound;
  for (int i = 0; i < 4; ++i) {
    const int err = make_map4(&m[i], srcs[i], dh, maps + 8 * i);
    if (err) return err;
    a.slots[i] = (int)maps[8 * i + 6];
  }
  const long long* s = strides + 12;  // dq, dk, dv
  a.lse2 = static_cast<const float*>(scratch);
  a.D = a.lse2 + (long long)n * p * lpad;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.cos_t = static_cast<const float*>(cos_t);
  a.sin_t = static_cast<const float*>(sin_t);
  a.sdq = {s[0], s[1], s[2]};
  a.sdk = {s[3], s[4], s[5]};
  a.sdv = {s[6], s[7], s[8]};
  a.L = l;
  a.lpad = lpad;
  a.P = p;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = prep(q, k, o, dout, lse, qm, km, scratch, cos_t, sin_t, n, l, p, dh, lpad,
                       strides, st);
  if (err) return err;
  return dh == 64 ? launch_bwd<64>(m, a, n * p, st) : launch_bwd<32>(m, a, n * p, st);
}
