// Multi-head attention forward for Hopper (sm_90a), one source for every
// attention entry point of the port:
//
//   window_attention_rope_packed  replaces sam3_lora_tpu/ops/window_attention.py
//                                 ::window_attention_rope_packed (Pallas kernel
//                                 _fwd_kernel_rope_packed), the 28 windowed ViT
//                                 blocks: 576-token windows, 16 heads x 64.
//   window_attention_packed       replaces ::window_attention_packed (K1', the
//                                 same without RoPE, _fwd_kernel_packed).
//   window_attention[_rope]_grouped  replace ::_window_pallas (W-g, head-grouped
//   window_attention[_rope]_pair_packed  (B, H, L, D)) and ::_window_pallas_packed
//                                 (W-p, the same packed in head pairs).
//   window_attention[_rope]_qkv   replaces sam3_lora_tpu/ops/window_qkv.py
//                                 ::_call_fwd (W-qkv, off the qkv projection).
//   long_attention_rope_packed    replaces sam3_lora_tpu/ops/long_attention.py
//                                 ::long_attention_rope_packed (_make_fwd_kernel
//                                 with rope), the 4 global ViT blocks: 5184
//                                 tokens, 16 heads x 64.
//   long_attention_packed         replaces long_attention.py::long_attention_packed
//                                 (_make_fwd_kernel without rope), the 6
//                                 fusion-encoder self-attentions: 5184 tokens,
//                                 8 heads x 32.
//
// All are unmasked, bias-free, non-causal attention over N x P heads of width
// DH, with an optional rotate-half RoPE on q and k from (L, DH/2) fp32 cos/sin
// tables. They differ only in where the heads lie, which the TPU kernels had
// to fix in their block shapes; here each operand is an (N, P, L, DH) view with
// its own (n, p, l) strides (Strides in attention_common.cuh), so the packed
// (N, L, P*DH) layout, views of the qkv projection output and head-major
// (B, H, L, D) tensors are all read in place. The last dim must be contiguous.
//
// What bounds it on the H100: each (query, key) pair costs 4*DH flops of QK^T
// and PV against 4*DH bytes of bf16 K/V that every 64-row query tile re-reads
// (from L2: one head's K/V is at most 1.3 MB), so with S kept on chip the
// kernel is bound by tensor-core issue. The design keeps S, P and O in
// registers: one block of 4 warps owns a 64-row query tile of one head; each
// warp holds its 16 query rows as mma.sync A fragments, streams 64-key K/V
// tiles through shared memory (ldmatrix), computes S = QK^T with
// m16n8k16 bf16 mma.sync into fp32, runs an exact max-shift online softmax on
// the accumulators, and feeds P, rounded to bf16, straight back as the A
// operand of PV (the accumulator layout of two n8 tiles is the A layout of one
// k16 step). The ragged tail of L is masked in the kernel (no padding). RoPE is
// applied in registers as q and k travel from device memory to shared memory,
// in fp32 and rounded back to bf16, as the JAX kernels do. Left for later: a
// wgmma/TMA pipeline and overlap of the K/V loads with the math.
//
// For training, the kernel also writes each row's fp32 log-sum-exp of the
// scaled scores, (N, P, L), when given a pointer for it; the backward
// (attention_bwd.cu) recovers P from it without a second pass over K.
//
// Softmax: exact max-shift. The JAX kernels default to a clamp form
// exp(min(s, 70)) / (sum + 1e-35), which equals this whenever the row max is
// at most 70; above that the clamp saturates and this kernel does not.

#include "attention_common.cuh"

namespace {

using namespace sam3;

template <int DH, bool ROPE>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ cos_t,
                     const float* __restrict__ sin_t, int L, int P, Strides sq,
                     Strides sk, Strides sv, Strides so, float scale) {
  using Lay = Layout<DH>;
  constexpr int LDH = Lay::LDH;
  constexpr int KS = DH / 16;  // k16 steps over the head dim
  constexpr int NT = BK / 8;   // n8 tiles of scores per K tile
  constexpr int OT = DH / 8;   // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + Lay::tile;
  bf16* Vs = Ks + Lay::tile;

  const int head = blockIdx.y;
  const long long n = head / P;
  const int p = head % P;
  const int q0 = blockIdx.x * BQ;
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

    // online softmax on the accumulators (exact max shift, fp32)
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
    uint32_t pf[BK / 16][4];  // P as A fragments, one per 16-key step
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(s[j][0] - m_run[0]), p1 = exp2f(s[j][1] - m_run[0]);
      const float p2 = exp2f(s[j][2] - m_run[1]), p3 = exp2f(s[j][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= L) continue;
    const float inv = 1.f / l_run[r];
    bf16* dst = o + so.at(n, p) + (long long)row * so.l + t * 2;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(acc[j][r * 2] * inv, acc[j][r * 2 + 1] * inv);
    // natural log-sum-exp of the scaled scores: ln(2^m * l)
    if (lse != nullptr && t == 0)
      lse[(long long)head * L + row] = (m_run[r] + log2f(l_run[r])) * LN2;
  }
}

template <int DH, bool ROPE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const float* cos_t, const float* sin_t, int n, int l, int p,
                   Strides sq, Strides sk, Strides sv, Strides so, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = 3 * Layout<DH>::tile * sizeof(bf16);  // Q, K, V
  auto kern = attention_fwd_kernel<DH, ROPE>;
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

// C entry point, bound with ctypes. q, k, v and o are (n, p, l, dh) bf16
// views, each given by its (n, p, l) strides in elements (`strides`: 4 x 3, in
// that order), with a contiguous last dim. lse is an (n, p, l) fp32 output, or
// null when no gradient is needed. cos_t/sin_t are (l, dh/2) fp32 tables, or
// null for no RoPE. Returns the cudaError_t of the launch (0 = success).
extern "C" int sam3_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const void* cos_t,
                                  const void* sin_t, int n, int l, int p, int dh,
                                  const long long* strides, float scale, void* stream) {
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  float* m = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rope = c != nullptr;
  const long long* z = strides;
  const Strides sq{z[0], z[1], z[2]}, sk{z[3], z[4], z[5]}, sv{z[6], z[7], z[8]},
      so{z[9], z[10], z[11]};
#define SAM3_LAUNCH(DH_, ROPE_) \
  launch<DH_, ROPE_>(q, k, v, o, m, c, s, n, l, p, sq, sk, sv, so, scale, st)
  if (dh == 64) return rope ? SAM3_LAUNCH(64, true) : SAM3_LAUNCH(64, false);
  if (dh == 32) return rope ? SAM3_LAUNCH(32, true) : SAM3_LAUNCH(32, false);
#undef SAM3_LAUNCH
  return (int)cudaErrorInvalidValue;
}
