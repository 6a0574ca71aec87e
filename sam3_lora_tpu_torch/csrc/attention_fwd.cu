// Multi-head attention forward for Hopper (sm_90a), one source for every
// attention entry point of the port:
//
//   window_attention_rope_packed  replaces sam3_lora_tpu/ops/window_attention.py
//                                 ::window_attention_rope_packed (:663, Pallas
//                                 kernel _fwd_kernel_rope_packed :411,
//                                 pallas_call :625), the 28 windowed ViT
//                                 blocks: 576-token windows, 16 heads x 64.
//   window_attention_packed       replaces ::window_attention_packed (:639, K1',
//                                 the same without RoPE, _fwd_kernel_packed :397).
//   window_attention[_rope]_grouped  replace ::_window_pallas (:507, W-g, head-
//   window_attention[_rope]_pair_packed  grouped (B, H, L, D)) and
//                                 ::_window_pallas_packed (:584, W-p, the same
//                                 packed in head pairs).
//   window_attention[_rope]_qkv   replaces sam3_lora_tpu/ops/window_qkv.py
//                                 ::_call_fwd (:178, W-qkv, off the qkv projection).
//   long_attention_rope_packed    replaces sam3_lora_tpu/ops/long_attention.py
//                                 ::long_attention_rope_packed (:427,
//                                 _make_fwd_kernel :181 with rope, pallas_call
//                                 :343), the 4 global ViT blocks: 5184 tokens,
//                                 16 heads x 64.
//   long_attention_packed         replaces long_attention.py::long_attention_packed
//                                 (:406, _make_fwd_kernel without rope), the 6
//                                 fusion-encoder self-attentions: 5184 tokens,
//                                 8 heads x 32.
//
// All are unmasked, bias-free, non-causal attention over N x P heads of width
// DH, with an optional rotate-half RoPE on q and k from (L, DH/2) fp32 cos/sin
// tables. They differ only in where the heads lie, which the TPU kernels had
// to fix in their block shapes; here each operand is an (N, P, L, DH) view with
// its own (n, p, l) strides, read by 4-D TMA maps ordered by stride
// (ops/attention_kernel.py::tma_map), so the packed (N, L, P*DH) layout, views
// of the qkv projection output and head-major (B, H, L, D) tensors are all
// read in place. The last dim must be contiguous, the base and every stride
// 16-byte aligned; the wrapper raises otherwise.
//
// Two kernels:
//   * rope_kernel (with RoPE only): q and k rotated once into contiguous
//     (N, P, L, DH) bf16 scratch, fp32 math and bf16 rounding, the bits of
//     ops/rope.py::apply_rope_half (attention_sm90.cuh::rotate_row, which the
//     backward's prep pass shares). Each row of k was rotated once per 64-row
//     query tile before (9 times at L = 576, 81 at 5184, with 16 KB of fp32
//     tables a tile); now once, for a copy of q and k.
//   * attention_fwd_kernel (attention_fwd.cuh, STAGE = FULL): a CTA owns 64
//     query rows of one head, one consumer warpgroup and one producer warp.
//     Q comes in once by TMA; the producer streams 64-key (K, V) tiles
//     through a 3-stage ring (a full and an empty mbarrier each); the
//     consumers run wgmma S = Q K^T (A, B K-major, 128- or 64-byte swizzle),
//     the exact max-shift online softmax in exp2 units on the accumulators
//     (keys >= L, TMA's zero rows, masked to -inf), and wgmma O += P V with
//     P rounded to bf16 as a register A operand and V read MN-major; the
//     stage is released once PV has retired. Rows < L of O / l go as bf16
//     straight from registers into the strided output view; with lse, each
//     row's fp32 natural log-sum-exp, (N, P, L), for the backward
//     (attention_bwd.cu).
//
// What bounds it on the H100: each head costs 4 * L^2 * DH operations (QK^T
// and PV) at 989 TFLOP/s against 8 * L * DH bytes (q, k, v, o once) at 3.35
// TB/s: the operations at L = 5184 (K2, K3), the bytes at L = 576 (the window
// rows), where L^2 is small. What the design does about the previous one
// (mma.sync fed by ldmatrix from synchronous, register-staged loads, RoPE
// on every K tile, 138 registers): the loads are TMA into a ring that runs
// ahead of the math, no register staging; the products are wgmma, the only
// path to the full tensor-core rate; RoPE is applied once; the softmax stays
// in the registers the products write.
//
// Tile: 64-row CTAs of 5 warps (160 threads), 3 stages,
// __launch_bounds__(160, 3): three CTAs an SM, so one CTA's softmax, loads
// and epilogue overlap another's products (nvcc -Xptxas -v: 128 registers
// at DH 64, 106 at 32, no spills; the rotation pass 54). L = 576 is 9 x 64
// and 5184 is 81 x 64, so no warpgroup idles on a last tile. No setmaxnreg:
// it takes whole warpgroups, and a producer warpgroup would cost more
// registers than its one warp. Tried on the card and not kept, each slower
// on the full rung at B = 8 or no faster: CTAs of two and three consumer
// warpgroups (128 and 192 rows) sharing each stage; four CTAs an SM at 96
// registers; the next tile's S issued before this tile's softmax, with two
// S and P register sets (161-168 registers, two CTAs an SM); PV left in
// flight into the next tile's S; Q as the register A operand of S (and the
// FULL_FEXP rung's instance computed wrong results across K tiles with
// it, a register hazard not found). The alternative to the rotation pass,
// rotating each K tile in shared memory as it lands, was not tried: the
// pass costs a copy of q and k.
//
// Softmax: exact max-shift, the row max taken on the raw scores, the scale
// folded into the exponent's multiply-add, the exponential on the
// approximate unit (ex2.approx, relative error ~2^-22, below P's bf16
// rounding), the mask applied on a ragged last tile only: the softmax's
// instructions, more than the products, set the length of a tile's chain
// (S, its wait, the softmax, PV), and these shortened it on the card.
// The JAX kernels default to a clamp form
// exp(min(s, 70)) / (sum + 1e-35), which equals this whenever the row max is
// at most 70; above that the clamp saturates and this kernel does not.
//
// The window-kernel probes (probe_window.cu) build the same body at every
// other stage, so this source's instance is their FULL rung.

#include "attention_fwd.cuh"

using namespace sam3;

// C entry points, bound with ctypes; each returns the first cudaError_t that
// is not 0 (a map cuTensorMapEncodeTiled refused: 100000 plus its
// CUresult), or 0.
//
// sam3_attention_rope: q, k (n, p, l, dh) bf16 views given by their (n, p, l)
// strides in elements (`strides`: 2 x 3) with a contiguous last dim, rotated
// by the (l, dh/2) fp32 tables into the contiguous (n, p, l, dh) qr, kr.
//
// sam3_attention_fwd: the forward. Its main kernel reads qm, km and v, each
// described by 8 numbers of `maps` (3 x 8, see attention_sm90.cuh::make_map4):
// with cos_t/sin_t ((l, dh/2) fp32), qm and km are contiguous (n, p, l, dh)
// scratch that the rotation pass fills from q and k first; without, they
// are q and k. o is an (n, p, l, dh) bf16 view; `strides`: the (n, p, l)
// strides of q, k and o (3 x 3). lse is an (n, p, l) fp32 output, or null
// when no gradient is needed. Each CTA walks `wpc` heads. The maps are
// encoded before the first launch, so the two kernels queue back to back.
extern "C" int sam3_attention_rope(const void* q, const void* k, void* qr, void* kr,
                                   const void* cos_t, const void* sin_t, int n, int l, int p,
                                   int dh, const long long* strides, void* stream) {
  const float *c = static_cast<const float*>(cos_t), *s = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_rope<64>(q, k, qr, kr, c, s, n, l, p, strides, st);
  if (dh == 32) return launch_rope<32>(q, k, qr, kr, c, s, n, l, p, strides, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sam3_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  void* qm, void* km, const void* cos_t, const void* sin_t, int n,
                                  int l, int p, int dh, int wpc, const long long* strides,
                                  const long long* maps, float scale, void* stream) {
  if ((dh != 64 && dh != 32) || wpc < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  FwdArgs a;
  int err = fwd_setup(m, a, qm, km, v, o, lse, l, p, n * p, dh, wpc, strides + 6, maps, scale);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cos_t != nullptr) {
    err = sam3_attention_rope(q, k, qm, km, cos_t, sin_t, n, l, p, dh, strides, stream);
    if (err) return err;
  }
  return dh == 64 ? launch_fwd<64, FULL, false>(m, a, st) : launch_fwd<32, FULL, false>(m, a, st);
}
