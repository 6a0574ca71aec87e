// Packed multi-head attention backward for Hopper (sm_90a): dQ, dK, dV of the
// forward in attention_fwd.cu, one source for the three entry points of the
// training path:
//
//   window_attention_rope_packed  replaces sam3_lora_tpu/ops/window_attention.py
//                                 _bwd_kernel_rope_packed (via _packed_pallas),
//                                 the 28 windowed ViT blocks: 576-token
//                                 windows, 16 heads x 64.
//   long_attention_rope_packed    replaces sam3_lora_tpu/ops/long_attention.py
//   long_attention_packed         _make_bwd_kernel (via _bwd_call), with and
//                                 without rope: the 4 global ViT blocks (5184
//                                 tokens, 16 x 64) and the 6 fusion-encoder
//                                 self-attentions (5184 tokens, 8 x 32).
//
// It computes the standard attention backward, FlashAttention-2 style, from
// q, k, v, the saved output O, dO and the forward's fp32 row log-sum-exp:
//
//   P  = exp(Q K^T * scale - LSE)         recomputed tile by tile
//   D  = rowsum(dO o O)                   fp32, one small pass (rowdot_kernel)
//   dV = P^T dO
//   dS = P o (dO V^T - D)
//   dQ = dS K * scale,  dK = dS^T Q * scale
//
// in two passes that own their outputs, so there are no atomics and the
// result is deterministic:
//   * dkdv_kernel: one block of 4 warps per (64-key tile, head); each warp
//     holds its 16 keys of K and V as mma.sync A fragments and loops over the
//     64-query tiles, forming S^T and dP^T in registers, turning P^T and dS^T
//     into A fragments of the next products (as the forward does with P), and
//     accumulating dV and dK in fp32 registers; each written once.
//   * dq_kernel: one block per (64-query tile, head), holding Q and dO as A
//     fragments and looping over the K/V tiles, accumulating dQ likewise.
// With RoPE, q and k are rotated in fp32 on the way into shared memory and
// rounded to bf16, as in the forward, and dQ and dK are rotated back (the
// transpose of the rotation) before the write: they are the gradients of the
// unrotated inputs. The ragged tail of L is masked (keys past L get P = 0,
// rows past L are not written). Outputs take row strides, so the three
// gradients of a packed qkv tensor land in one (N, L, 3*P*DH) buffer.
//
// What bounds it on the H100: each (query, key) pair costs 8*DH flops of
// tensor-core work across the two passes (S twice, dP twice, dV, dK, dQ)
// against tiles re-read from L2, so it is bound by tensor-core issue like the
// forward. Left for later: a wgmma/TMA pipeline and load/math overlap.

#include "attention_common.cuh"

namespace {

using namespace sam3;

// D[n, p, l] = sum_d dO[n, p, l, d] * O[n, p, l, d] in fp32: one warp per
// (n, l) row, 16-byte chunks, a shuffle sum within each head's lanes.
template <int DH>
__global__ void __launch_bounds__(THREADS)
rowdot_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
              float* __restrict__ D, int N, int L, int P, Strides so, Strides sd) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= (long long)N * L) return;  // uniform across the warp
  const long long n = row / L;
  const int l = (int)(row % L);
  const int lane = threadIdx.x % 32;
  constexpr int G = DH / 8;  // lanes per head (divides 32)
  const int chunks = P * G;
  const bf16* orow = o + so.at(n, 0) + (long long)l * so.l;
  const bf16* drow = dout + sd.at(n, 0) + (long long)l * sd.l;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    if (c < chunks) {
      const int h = c / G, d = (c % G) * 8;  // head, first of its 8 elements
      const uint4 a = *reinterpret_cast<const uint4*>(orow + h * so.p + d);
      const uint4 b = *reinterpret_cast<const uint4*>(drow + h * sd.p + d);
      const bf16* pa = reinterpret_cast<const bf16*>(&a);
      const bf16* pb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += __bfloat162float(pa[j]) * __bfloat162float(pb[j]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (c < chunks && lane % G == 0) D[(n * P + c / G) * L + l] = acc;
  }
}

// Scale the two accumulator rows of this thread, rotate them back with the
// transpose of the forward's rotate-half RoPE at sequence position `row`, and
// write them as bf16 at `dst` (this thread's first column of the row).
template <int DH, bool ROPE>
__device__ __forceinline__ void store_rows(float (&acc)[DH / 8][4], bf16* base,
                                           long long sl, int row0, int L,
                                           float scale, const float* __restrict__ cos_t,
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
      x[j][0] = acc[j][r * 2] * scale;
      x[j][1] = acc[j][r * 2 + 1] * scale;
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

template <int DH, bool ROPE>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            bf16* __restrict__ dk, bf16* __restrict__ dv,
            const float* __restrict__ cos_t, const float* __restrict__ sin_t, int L,
            int P, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
            Strides sdv, float scale) {
  using Lay = Layout<DH>;
  constexpr int LDH = Lay::LDH;
  constexpr int KS = DH / 16;  // k16 steps over the head dim
  constexpr int NT = BQ / 8;   // n8 tiles of S^T per query tile
  constexpr int OT = DH / 8;   // n8 tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + Lay::tile;
  bf16* Ks = dOs + Lay::tile;
  bf16* Vs = Ks + Lay::tile;
  float* lse_s = reinterpret_cast<float*>(Vs + Lay::tile);  // log2 units
  float* D_s = lse_s + BQ;

  const int head = blockIdx.y;
  const long long n = head / P;
  const int p = head % P;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;

  load_tile<DH, ROPE>(Ks, k + sk.at(n, p) + (long long)k0 * sk.l, sk.l,
                      min(BK, L - k0), cos_t, sin_t, k0);
  load_tile<DH, false>(Vs, v + sv.at(n, p) + (long long)k0 * sv.l, sv.l,
                       min(BK, L - k0), nullptr, nullptr, 0);
  __syncthreads();
  uint32_t kf[KS][4], vf[KS][4];  // this warp's 16 keys of K and V as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a(kf[kk], Ks + warp * 16 * LDH + kk * 16, LDH);
    load_a(vf[kk], Vs + warp * 16 * LDH + kk * 16, LDH);
  }

  const float sl2 = scale * LOG2E;
  const float* lse_h = lse + (long long)head * L;
  const float* D_h = D + (long long)head * L;
  float dka[OT][4], dva[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BQ) {
    const int q_valid = min(BQ, L - q0);
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<DH, ROPE>(Qs, q + sq.at(n, p) + (long long)q0 * sq.l, sq.l, q_valid,
                        cos_t, sin_t, q0);
    load_tile<DH, false>(dOs, dout + sdo.at(n, p) + (long long)q0 * sdo.l, sdo.l,
                         q_valid, nullptr, nullptr, 0);
    if (threadIdx.x < BQ) {
      const int r = threadIdx.x;  // rows past L get P = 0 through an infinite LSE
      lse_s[r] = r < q_valid ? lse_h[q0 + r] * LOG2E : INFINITY;
      D_s[r] = r < q_valid ? D_h[q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        load_b_nk(b, Qs + j * 8 * LDH + kk * 16, LDH);
        mma(st[j], kf[kk], b[0], b[1]);
        mma(st[j + 1], kf[kk], b[2], b[3]);
        load_b_nk(b, dOs + j * 8 * LDH + kk * 16, LDH);
        mma(dpt[j], vf[kk], b[0], b[1]);
        mma(dpt[j + 1], vf[kk], b[2], b[3]);
      }
    }

    // P^T and dS^T = P^T o (dP^T - D), packed as A fragments over the queries
    uint32_t pf[BQ / 16][4], sf[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + t * 2;  // this thread's two query columns
      const float l0 = lse_s[c], l1 = lse_s[c + 1], d0 = D_s[c], d1 = D_s[c + 1];
      const float p0 = exp2f(st[j][0] * sl2 - l0), p1 = exp2f(st[j][1] * sl2 - l1);
      const float p2 = exp2f(st[j][2] * sl2 - l0), p3 = exp2f(st[j][3] * sl2 - l1);
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      sf[j / 2][(j & 1) * 2] = pack_bf16(p0 * (dpt[j][0] - d0), p1 * (dpt[j][1] - d1));
      sf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2 * (dpt[j][2] - d0), p3 * (dpt[j][3] - d1));
    }

    // dV += P^T dO, dK += dS^T Q (contracting over the 64 queries)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t b[4];
        load_b_kn(b, dOs + kk * 16 * LDH + j * 8, LDH);
        mma(dva[j], pf[kk], b[0], b[1]);
        mma(dva[j + 1], pf[kk], b[2], b[3]);
        load_b_kn(b, Qs + kk * 16 * LDH + j * 8, LDH);
        mma(dka[j], sf[kk], b[0], b[1]);
        mma(dka[j + 1], sf[kk], b[2], b[3]);
      }
    }
  }

  const int row0 = k0 + warp * 16;
  store_rows<DH, ROPE>(dka, dk + sdk.at(n, p), sdk.l, row0, L, scale, cos_t, sin_t);
  store_rows<DH, false>(dva, dv + sdv.at(n, p), sdv.l, row0, L, 1.f, nullptr, nullptr);
}

template <int DH, bool ROPE>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          bf16* __restrict__ dq, const float* __restrict__ cos_t,
          const float* __restrict__ sin_t, int L, int P, Strides sq, Strides sk,
          Strides sv, Strides sdo, Strides sdq, float scale) {
  using Lay = Layout<DH>;
  constexpr int LDH = Lay::LDH;
  constexpr int KS = DH / 16;
  constexpr int NT = BK / 8;  // n8 tiles of S per K tile
  constexpr int OT = DH / 8;  // n8 tiles of dQ
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + Lay::tile;
  bf16* Ks = dOs + Lay::tile;
  bf16* Vs = Ks + Lay::tile;

  const int head = blockIdx.y;
  const long long n = head / P;
  const int p = head % P;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q_valid = min(BQ, L - q0);

  load_tile<DH, ROPE>(Qs, q + sq.at(n, p) + (long long)q0 * sq.l, sq.l, q_valid,
                      cos_t, sin_t, q0);
  load_tile<DH, false>(dOs, dout + sdo.at(n, p) + (long long)q0 * sdo.l, sdo.l,
                       q_valid, nullptr, nullptr, 0);
  __syncthreads();
  uint32_t qf[KS][4], df[KS][4];  // this warp's 16 rows of Q and dO
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a(qf[kk], Qs + warp * 16 * LDH + kk * 16, LDH);
    load_a(df[kk], dOs + warp * 16 * LDH + kk * 16, LDH);
  }
  float lse2[2], dd[2];  // rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    lse2[r] = row < L ? lse[(long long)head * L + row] * LOG2E : INFINITY;
    dd[r] = row < L ? D[(long long)head * L + row] : 0.f;
  }

  const float sl2 = scale * LOG2E;
  const bf16* kb = k + sk.at(n, p);
  const bf16* vb = v + sv.at(n, p);
  float dqa[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    const int kv_valid = min(BK, L - k0);
    __syncthreads();
    load_tile<DH, ROPE>(Ks, kb + (long long)k0 * sk.l, sk.l, kv_valid, cos_t, sin_t, k0);
    load_tile<DH, false>(Vs, vb + (long long)k0 * sv.l, sv.l, kv_valid, nullptr, nullptr, 0);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        load_b_nk(b, Ks + j * 8 * LDH + kk * 16, LDH);
        mma(s[j], qf[kk], b[0], b[1]);
        mma(s[j + 1], qf[kk], b[2], b[3]);
        load_b_nk(b, Vs + j * 8 * LDH + kk * 16, LDH);
        mma(dp[j], df[kk], b[0], b[1]);
        mma(dp[j + 1], df[kk], b[2], b[3]);
      }
    }

    // dS = P o (dP - D), keys past L masked to P = 0, as A fragments over keys
    uint32_t sf[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1), r = e >> 1;
        const float pv = col < kv_valid ? exp2f(s[j][e] * sl2 - lse2[r]) : 0.f;
        ds[e] = pv * (dp[j][e] - dd[r]);
      }
      sf[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      sf[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K (contracting over the 64 keys)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t b[4];
        load_b_kn(b, Ks + kk * 16 * LDH + j * 8, LDH);
        mma(dqa[j], sf[kk], b[0], b[1]);
        mma(dqa[j + 1], sf[kk], b[2], b[3]);
      }
    }
  }

  store_rows<DH, ROPE>(dqa, dq + sdq.at(n, p), sdq.l, q0 + warp * 16, L, scale, cos_t,
                       sin_t);
}

struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dout;
  const float *lse, *cos_t, *sin_t;
  float* D;
  bf16 *dq, *dk, *dv;
  int n, l, p;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  float scale;
};

template <int DH, bool ROPE>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.n * a.l;
  rowdot_kernel<DH><<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
      a.o, a.dout, a.D, a.n, a.l, a.p, a.so, a.sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((a.l + 63) / 64, a.n * a.p);
  constexpr int tiles = 4 * Layout<DH>::tile * sizeof(bf16);  // Q, dO, K, V
  constexpr int dkdv_bytes = tiles + 2 * BQ * sizeof(float);
  auto kdkdv = dkdv_kernel<DH, ROPE>;
  err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  kdkdv<<<grid, THREADS, dkdv_bytes, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.D, a.dk, a.dv, a.cos_t, a.sin_t, a.l, a.p, a.sq,
      a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kdq = dq_kernel<DH, ROPE>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, tiles);
  if (err != cudaSuccess) return err;
  kdq<<<grid, THREADS, tiles, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.D, a.dq, a.cos_t, a.sin_t, a.l, a.p, a.sq, a.sk,
      a.sv, a.sdo, a.sdq, a.scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q/k/v/o/dout and the outputs dq/dk/dv are
// (n, p, l, dh) bf16 views, each given by its (n, p, l) strides in elements
// (`strides`: 8 x 3, in that order), with a contiguous last dim; lse is the
// forward's (n, p, l) fp32 log-sum-exp; D is (n, p, l) fp32 scratch.
// cos_t/sin_t are (l, dh/2) fp32 tables, or null for no RoPE. Launches three
// kernels on `stream`; returns the first cudaError_t that is not 0, or 0.
extern "C" int sam3_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* D, void* dq, void* dk, void* dv, const void* cos_t,
    const void* sin_t, int n, int l, int p, int dh, const long long* strides,
    float scale, void* stream) {
  const long long* s = strides;
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                  static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
                  static_cast<float*>(D), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv), n, l, p,
                  {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
                  {s[9], s[10], s[11]}, {s[12], s[13], s[14]}, {s[15], s[16], s[17]},
                  {s[18], s[19], s[20]}, {s[21], s[22], s[23]}, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rope = cos_t != nullptr;
  if (dh == 64) return rope ? launch_bwd<64, true>(a, st) : launch_bwd<64, false>(a, st);
  if (dh == 32) return rope ? launch_bwd<32, true>(a, st) : launch_bwd<32, false>(a, st);
  return (int)cudaErrorInvalidValue;
}
