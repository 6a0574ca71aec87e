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
//
// The kernel's body is in attention_fwd.cuh, templated on a stage: this
// source builds STAGE = FULL, and the window-kernel probes (probe_window.cu)
// build the other rungs from the same body.

#include "attention_fwd.cuh"

using namespace sam3;

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
  launch_fwd<DH_, ROPE_, FULL>(q, k, v, o, m, c, s, n, l, p, sq, sk, sv, so, scale, st)
  if (dh == 64) return rope ? SAM3_LAUNCH(64, true) : SAM3_LAUNCH(64, false);
  if (dh == 32) return rope ? SAM3_LAUNCH(32, true) : SAM3_LAUNCH(32, false);
#undef SAM3_LAUNCH
  return (int)cudaErrorInvalidValue;
}
