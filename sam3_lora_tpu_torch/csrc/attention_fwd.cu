// Packed multi-head attention forward for Hopper (sm_90a), one source for the
// three attention entry points of the serving path:
//
//   window_attention_rope_packed  replaces sam3_lora_tpu/ops/window_attention.py
//                                 ::window_attention_rope_packed (Pallas kernel
//                                 _fwd_kernel_rope_packed), the 28 windowed ViT
//                                 blocks: 576-token windows, 16 heads x 64.
//   long_attention_rope_packed    replaces sam3_lora_tpu/ops/long_attention.py
//                                 ::long_attention_rope_packed (_make_fwd_kernel
//                                 with rope), the 4 global ViT blocks: 5184
//                                 tokens, 16 heads x 64.
//   long_attention_packed         replaces long_attention.py::long_attention_packed
//                                 (_make_fwd_kernel without rope), the 6
//                                 fusion-encoder self-attentions: 5184 tokens,
//                                 8 heads x 32.
//
// All three are unmasked, bias-free, non-causal attention over P heads of width
// DH that sit side by side in the last dim of (N, L, P*DH) operands, with an
// optional rotate-half RoPE on q and k from (L, DH/2) fp32 cos/sin tables.
// Rows may be strided (the ViT passes q/k/v as views of its qkv projection
// output); the last dim must be contiguous.
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
// Softmax: exact max-shift. The JAX kernels default to a clamp form
// exp(min(s, 70)) / (sum + 1e-35), which equals this whenever the row max is
// at most 70; above that the clamp saturates and this kernel does not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int BK = 64;  // keys per streamed tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Layout {
  static constexpr int LDH = DH + 8;  // bf16 row stride: conflict-free ldmatrix
  static constexpr size_t tile = size_t(64) * LDH;  // elements per 64-row tile
  static constexpr size_t bytes = 3 * tile * sizeof(bf16);  // Q, K, V
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b for one m16n8k16 tile, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Copy `rows_valid` rows of DH bf16 into a 64-row shared tile (rows past the
// end are zero). With ROPE, each thread carries a chunk of the first half of
// a row and the matching chunk of the second half, and rotates them in
// registers: x[:h], x[h:] -> x[:h]*cos - x[h:]*sin, x[:h]*sin + x[h:]*cos,
// with the tables at sequence position row0 + r.
template <int DH, bool ROPE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld,
                                          int rows_valid, const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, int row0) {
  constexpr int LDH = Layout<DH>::LDH;
  if (!ROPE) {
    constexpr int CPR = DH / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < 64 * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
      *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
    }
    return;
  }
  constexpr int H = DH / 2;
  constexpr int CPH = H / 8;  // chunks per half row
  for (int i = threadIdx.x; i < 64 * CPH; i += THREADS) {
    const int r = i / CPH, c = (i % CPH) * 8;
    uint4 ve = make_uint4(0u, 0u, 0u, 0u), vo = ve;
    if (r < rows_valid) {
      ve = *reinterpret_cast<const uint4*>(src + r * ld + c);
      vo = *reinterpret_cast<const uint4*>(src + r * ld + c + H);
      const float* cs = cos_t + (long long)(row0 + r) * H + c;
      const float* sn = sin_t + (long long)(row0 + r) * H + c;
      const float4 c0 = *reinterpret_cast<const float4*>(cs);
      const float4 c1 = *reinterpret_cast<const float4*>(cs + 4);
      const float4 s0 = *reinterpret_cast<const float4*>(sn);
      const float4 s1 = *reinterpret_cast<const float4*>(sn + 4);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const bf16* pe = reinterpret_cast<const bf16*>(&ve);
      const bf16* po = reinterpret_cast<const bf16*>(&vo);
      uint4 re, ro;
      uint32_t* qe = reinterpret_cast<uint32_t*>(&re);
      uint32_t* qo = reinterpret_cast<uint32_t*>(&ro);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float e0 = __bfloat162float(pe[j]), e1 = __bfloat162float(pe[j + 1]);
        const float o0 = __bfloat162float(po[j]), o1 = __bfloat162float(po[j + 1]);
        qe[j / 2] = pack_bf16(e0 * cv[j] - o0 * sv[j], e1 * cv[j + 1] - o1 * sv[j + 1]);
        qo[j / 2] = pack_bf16(e0 * sv[j] + o0 * cv[j], e1 * sv[j + 1] + o1 * cv[j + 1]);
      }
      ve = re;
      vo = ro;
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = ve;
    *reinterpret_cast<uint4*>(dst + r * LDH + c + H) = vo;
  }
}

template <int DH, bool ROPE>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     const float* __restrict__ cos_t,
                     const float* __restrict__ sin_t, int L, int P,
                     long long q_sn, long long q_sl, long long k_sn,
                     long long k_sl, long long v_sn, long long v_sl,
                     long long o_sn, long long o_sl, float scale) {
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
  const bf16* kb = k + n * k_sn + p * DH;
  const bf16* vb = v + n * v_sn + p * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair

  load_tile<DH, ROPE>(Qs, q + n * q_sn + (long long)q0 * q_sl + p * DH, q_sl,
                      min(BQ, L - q0), cos_t, sin_t, q0);
  __syncthreads();
  uint32_t qf[KS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LDH + kk * 16 + (lane >> 4) * 8);

  const float sl2 = scale * LOG2E;  // exp(x) = exp2(x * log2 e)
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    const int kv_valid = min(BK, L - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DH, ROPE>(Ks, kb + (long long)k0 * k_sl, k_sl, kv_valid, cos_t, sin_t, k0);
    load_tile<DH, false>(Vs, vb + (long long)k0 * v_sl, v_sl, kv_valid, nullptr, nullptr, 0);
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
        ldmatrix_x4(b, Ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LDH + kk * 16 +
                           ((lane >> 3) & 1) * 8);
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
        ldmatrix_x4_trans(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH +
                                 j * 8 + (lane >> 4) * 8);
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
    bf16* dst = o + n * o_sn + (long long)row * o_sl + p * DH + t * 2;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(acc[j][r * 2] * inv, acc[j][r * 2 + 1] * inv);
  }
}

template <int DH, bool ROPE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const float* cos_t, const float* sin_t, int n, int l, int p,
                   long long q_sn, long long q_sl, long long k_sn,
                   long long k_sl, long long v_sn, long long v_sl,
                   long long o_sn, long long o_sl, float scale,
                   cudaStream_t stream) {
  using Lay = Layout<DH>;
  auto kern = attention_fwd_kernel<DH, ROPE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((l + BQ - 1) / BQ, n * p);
  kern<<<grid, THREADS, Lay::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), cos_t, sin_t, l, p,
      q_sn, q_sl, k_sn, k_sl, v_sn, v_sl, o_sn, o_sl, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Strides are in elements. cos_t/sin_t are
// (l, dh/2) fp32 tables, or null for no RoPE. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int sam3_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, const void* cos_t, const void* sin_t,
                                  int n, int l, int p, int dh, long long q_sn,
                                  long long q_sl, long long k_sn, long long k_sl,
                                  long long v_sn, long long v_sl, long long o_sn,
                                  long long o_sl, float scale, void* stream) {
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rope = c != nullptr;
#define SAM3_LAUNCH(DH_, ROPE_)                                                \
  launch<DH_, ROPE_>(q, k, v, o, c, s, n, l, p, q_sn, q_sl, k_sn, k_sl, v_sn, \
                     v_sl, o_sn, o_sl, scale, st)
  if (dh == 64) return rope ? SAM3_LAUNCH(64, true) : SAM3_LAUNCH(64, false);
  if (dh == 32) return rope ? SAM3_LAUNCH(32, true) : SAM3_LAUNCH(32, false);
#undef SAM3_LAUNCH
  return (int)cudaErrorInvalidValue;
}
