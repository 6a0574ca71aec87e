"""Smoke run of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device      - the card's name and power limit; TF32 off for fp32 math.
  2. build       - compile csrc/attention_fwd.cu, csrc/attention_bwd.cu,
                   csrc/gemm_int8.cu and csrc/probe_window.cu with nvcc (one
                   process per source, in parallel).
  3. kernels     - each attention entry point's forward (with RoPE its
                   rotation pass, then the TMA/wgmma main kernel) against its
                   plain PyTorch version, on the operands the serving path
                   hands it, launched twice for equal bits, with its share
                   of the bound and SDPA's time; the rotation pass alone bit
                   for bit against its plain version; the backward kernels (and the forward's
                   log-sum-exp) against attention_packed_bwd_plain on the
                   operands of the training path at batch 4, each also
                   launched twice for equal bits, with its share of the
                   5-product bound and of the 7-product floor; the window
                   routes K1', W-g, W-p and W-qkv (with and without RoPE)
                   forward at serving's 9 windows (twice, equal bits) and
                   backward at batch 8;
                   the int8 tier's K4/K6 (each its first pass and the
                   TMA/wgmma mainloop of csrc/gemm_sm90.cuh) and K5 (K4's
                   quantization fused with the xa product, and the
                   mainloop's low-rank step)
                   against their plain versions at every ViT shape at
                   M = 5184 (serving), 20736 (training) and 41472 (bench.py's
                   batch; K4 and K6), the text shapes at M = 96 and a ragged
                   M; K4 bit for bit, K5 twice for equal bits and also at
                   ranks 32 and 64 (fc1 serving); errors, median CUDA-event
                   times, roofline bounds and a library yardstick each; each
                   K5 line beside the unfused chain (K4, the two adapter
                   products, the add) and K4 of its shape.
  4. slice       - SAM3LoRAInference at the full 848M config (bf16, seeded random
                   weights, nonzero adapters): the model's own (eager) forward
                   of 1, 2 and 3 prompts, then _forward captures its CUDA
                   graphs (graphs.py: the backbone, a grounding a prompt
                   count; the launch counters twice the design's a capture,
                   its host s, the pool's bytes) and replays them, bit for bit
                   the eager forward, a request's device kernels the eager
                   one's (the device trace); then three requests of 1, 2 and
                   3 prompts from the graphs (no entry launches, two replays
                   a request); every output finite and of the right shape.
  5. slice-int8  - the same with base_quant="int8" and GEMM_LORA_FUSED on: the
                   adapted qkv/fc1/fc2 take K5, proj and the text GEMMs K4;
                   then one request of 1 prompt under torch.profiler: K5's
                   device ms (its first pass and its mainloop apart).
  6. train       - Trainer.fit at the full config, batch 4, LoRA on qkv, fc1,
                   fc2, linear1 and linear2, over seeded random images and
                   targets batched by the port's collate: one warm-up and three
                   timed steps with finite losses; step times, peak memory, and
                   forward and backward launch counts equal to the design's.
  7. train-int8  - the same with base_quant="int8" and GEMM_BWD_KERNEL on: K4
                   forward (remat replays included, 284 a step) and K6 for
                   the fc1/fc2 dx.
  8. bench-train - Trainer.fit at bench.py's configuration (bench_model_config
                   and bench_lora_config: bf16 storage, the int8 tier,
                   wo_block_mid, enc_remat_ffn, rank 32), batch 8: one
                   warm-up and three timed steps, launch counts equal to the
                   design's (no attention forward replays); then a fifth
                   step under torch.profiler: the top 15 kernels by device
                   time, K4's total and share, the device's busy share.
  9. routes      - one full-width bf16 model answers one request per window
                   route (default K1, QKV_NATIVE W-qkv, FUSE_ROPE off W-p,
                   _PACKED off W-g with and without RoPE): each runs its own
                   entry and no other, outputs within SMALL_TOL of the
                   default route's; a vit_use_rope=False model through K1',
                   W-qkv and W-g without RoPE.
 10. processor   - Sam3Processor at the full config (bf16; then the int8 tier
                   with GEMM_LORA_FUSED, as slice-int8): one set_image of the
                   1200x900 image, then PROMPTS[-1] one at a time, the last
                   with a box prompt. set_image launches K1 and K2 (and in
                   the int8 tier K5/K4 in the ViT's GEMMs), each prompt K3
                   and the text encoder's K4 and no ViT kernel (counts the
                   design's for each graph captured, none for a replay); the
                   cached features, a text and a box prompt's raw outputs bit
                   for bit the model's own eager forward's on the same image,
                   each unit's replayed device kernels the eager ones;
                   the median times (of 3) of set_image, each prompt, and
                   predict of the same prompts one at a time and together;
                   one set_image and one prompt under torch.profiler.
 11. validate    - cli.validate.validate_images over 8 seeded in-memory
                   samples (SyntheticSamples, a COCO image id each) in bf16:
                   forward, threshold, mask NMS, top 100; the RLE dump
                   (PredictionDumper, through the native RLE codec) decoded
                   back to the kept masks bit for bit, and its strings byte
                   for byte those of the same dump through the numpy
                   encoder; mAP, mAP_50, mAP_75 and cgF1 finite and in
                   [0, 1]; the NMS keep of one image's 200 candidates on the
                   card (ops.nms's host loop, and the device loop it was
                   measured against) bit for bit equal to the CPU's, with
                   the times of mask_iou and of each loop; the time split by
                   forward, NMS, dump (both encoders) and metrics, and
                   images/s.
 12. interactive - SAM3InteractiveImagePredictor on a bf16 Sam3Processor:
                   set_image of the 1200x900 image (K1 and K2 only), a click
                   with three masks and a box with a negative click with
                   one (no kernel), predict_batch over two images (K1 and K2
                   per image); the card's SAM heads within SMALL_TOL of their
                   fp32 CPU run on the cached features; interactive_ground
                   for 2 refinement steps, each stage K3 only, finite; the
                   median times of set_image, a click and a stage, and one
                   profiled click.
 13. agent       - the agent tier on the interactive phase's processor over
                   the 1200x900 image: tool_agent_inference with a scripted
                   LLM, at the threshold under the second phrase's 5 best
                   scores (segment_phrase, the same phrase
                   again, rejected, a second phrase, examine_each_mask with
                   Accept and Reject verdicts, select_masks_and_return),
                   set_image K1 x28 and K2 x4 once, each segment_phrase K3
                   x6 alone; the selected masks at 900x1200 those of the
                   processor's own set_text_prompt output at the picked
                   indices, with their boxes and scores; then
                   agent_inference with RuleBasedRefiner (4 rounds of
                   refined phrases); host s per tool call.
 14. model options - a geo_mask_prompts model grounds a 1200x900 mask prompt
                   (K3 only, finite, 72^2 more prompt tokens); the decoder's
                   dense boxRPB oracle within SMALL_TOL of the separable
                   route on one set of full-width weights and inputs; a
                   box_rpb="none" decoder's outputs finite.
 15. video       - VideoGrounder(propagate=True) on a bf16 Sam3Processor at
                   the full config, 16 slots, 7 memory frames, 16 pointers,
                   over 12 seeded 1200x900 frames with one prompt and
                   prob_threshold 0: each frame K1 x28, K2 x4, K3 x6 and
                   nothing else, finite logits, unique live ids, consistent
                   ages, a ring eviction; the tracker's propagate and memory
                   update on two live slots within SMALL_TOL of their fp32
                   CPU run; the association (mask IoU and the auction) and
                   the batched connected components (and the hole filling)
                   bit for bit the CPU's; host s a frame, one profiled
                   frame, each stage's host s, the memory attention's ms,
                   peak memory; Sam3TrackerPredictor (a click, a box for a
                   second object, propagate_in_video over the frames: K1/K2
                   once a frame, finite, memory written) and
                   Sam3VideoPredictor (two sessions interleaved, the first
                   again alone: equal outputs); saco_veval of the grounder's
                   tracks (prepare_video_predictions, one SacoVevalWriter
                   shard, every evaluator) against ground truth of the
                   tracks themselves (video mAP and phrase AP 1.0), less
                   one, one moved: every meter equal to
                   evaluate_saco_veval's on a copy of the records.
 16. video-train - one clip of 4 frames (make_synthetic_ytvis, 2 videos of
                   12 frames; VideoGroundingDataset at random strides) at
                   1008^2 through the full bf16 model in train mode as a
                   batch: semantic_seg_loss and point_sampled_mask_loss
                   (12544 points) on its outputs, one backward into the
                   adapters; the forward K1 x28, K2 x4, K3 x6 and the step
                   the train phase's design; each loss, the association
                   losses (seeded logits, the clip's track ids, one
                   duplicated) and the error-region sampler on the card
                   against the CPU (VT_RTOL; the sampler equal); host s,
                   peak memory, the losses' device ms.
 17. int8_bwd    - one full-width training step with base_quant="int8_bwd".
 18. scale-out   - at the full config, bf16, batch 4, LoRA on qkv, fc1, fc2,
                   linear1 and linear2, every dropout off: (a) Trainer.fit
                   (one warm-up, two timed updates) in an NCCL group of 1
                   (multihost.initialize from the environment, a free port)
                   against the same updates without a group, the adapters
                   bit for bit after every update, the launches the train
                   phase's design; (b) two processes on the one card
                   (``--scale-out-rank``, spawned after the build) in a gloo
                   group over CUDA tensors, 2 of the same 4 images each, one
                   update: the reduced gradients bit for bit those of the
                   same halves in one process (the group's counts given to
                   each), within GRAD_RTOL of (a)'s batch-4 gradients as one
                   vector (GRAD_RTOL_SPLIT by adapter), the halves' matching
                   the batch's, the adapters equal across the ranks,
                   the logged loss the group's mean near (a)'s, files
                   written by rank 0 alone, a failed or late rank fails the
                   phase; (c) FrameParallelDetector at world size 1 over 8
                   seeded 1200x900 frames, one prompt, chunks of 4: each
                   chunk K1 x28, K2 x4, K3 x6 and nothing else, every frame
                   within SMALL_TOL of _forward on it alone, host s a frame
                   against the frame-by-frame loop; (d) save_base_checkpoint
                   of a full-config model, loaded strictly into a fresh one
                   (every parameter bit for bit), and an int8-tier engine
                   built from the file against one quantized directly (one
                   request bit for bit); (e) a trace_span among one profiled
                   step's events, MemMeter's peak equal to
                   max_memory_allocated; (f) the sharded frozen base
                   (parallel.shard_params_ by param_shardings(...,
                   shard_base=True)) in the int8 tier at batch 4, one
                   update's forward and backward through train_step and the
                   group's mean gradient, after a warm-up update: (f1) in an
                   NCCL group of 1, the base "sharded" over one rank, bit for
                   bit the unsharded step, the same launches
                   (train_step_launches), the gathers in the forward and in
                   the backward; (f2) two gloo ranks on the one card
                   (``--fsdp-rank``), 2 images each, the reduced gradients
                   bit for bit the same ranks' unsharded step, each rank's
                   resident parameter bytes the rule's count, its peak
                   memory below unsharded, and its step's host s.
 19. resize      - the serving path's PIL-exact resizes on the card: three
                   uint8 images (480x640, 900x1200, 1080x1920) to 1008^2
                   byte for byte PIL's, preprocess equal to (PIL / 255 -
                   0.5) / 0.5, 8 masks 288^2 -> 900x1200 equal to PIL's mask
                   resize; preprocess's median host s at 900x1200 against
                   PIL's on the host.
 20. convert     - the full bf16 config: a seeded model's base written as a
                   reference-named fp32 .pt (reference_state_dict, the
                   converter's inverse), converted by cli.convert_checkpoint,
                   served by SAM3LoRAInference(base_checkpoint=...) through
                   K1-K3: one request's scores, boxes and masks bit for bit
                   the source model's; the convert and load seconds.
 21. merge       - merge_lora_into_base with live adapters at the full
                   config: in bf16 one request adapted, then merged, within
                   MERGE_CONTROL_FACTOR x a one-bf16-rounding control; in the
                   int8 tier an adapted request (K5 x96) against one of an
                   engine that merges the same adapters before quantizing (K4
                   alone), each request's launches and device ms.
 22. small       - a small config whose path runs every attention kernel: its
                   eval forward and one training step (loss, matching and
                   adapter gradients) in bf16 on the card against the same in
                   fp32 on the CPU; again with its ViT in the int8 tier; at
                   the bench settings (bf16 storage, int8 and int8_bwd); and
                   one training step per window route, with and without
                   RoPE.
 23. probes      - the window-kernel probes (sam3_lora_tpu_torch/probes:
                   window_cost, dma_floor, packed) at bench.py's batch 8
                   through their rows(): every stage rung (K1's own kernel
                   at each stage), op rate, work-per-CTA sweep and the
                   packed forward and backward, timed, each timed output
                   held against its plain version's on the same operands,
                   with the plain version's time, the bound, a yardstick and
                   the row's own launches; the full rung bit for bit equal to
                   attention_cuda and within 10% of its time (the two timed
                   in turns); each op-rate row with its instruction mix per
                   unit (window_cost.OP_MIX) beside the one its SASS issues
                   (window_cost.op_sass), its binding unit, its share of that
                   bound and the one-row bound it replaced; then
                   packed.check(), the pair forms against the per-head math.
                   No row may read bound/time over 1.05, and no op's SASS
                   may issue less than its mix on a unit or take longer on
                   any unit than the mix on its binding unit
                   (window_cost.sass_check); maxreduce and add_bf16 also
                   run a tile whose values they change
                   (window_cost.op_moving_input), bit for bit against
                   op_plain.
Then one JSON line of the kernels, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import collections
import copy
import functools
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from sam3_lora_tpu_torch.config import (
    LoRAConfig, ModelConfig, TrainConfig, bench_lora_config, bench_model_config, tiny_model_config,
)
from sam3_lora_tpu_torch.cli.validate import dump_predictions, score_predictions, validate_images
from sam3_lora_tpu_torch.eval import load_predictions
from sam3_lora_tpu_torch.inference import (
    IMAGE_MEAN, IMAGE_STD, SAM3LoRAInference, head_outputs, preprocess_image, resize_masks_to,
)
from sam3_lora_tpu_torch.measure import (
    KERNEL_BWD_RTOL, KERNEL_RTOL, PEAK_BF16, PEAK_INT8, attention_work, median_ms, paired_ms,
    profile_step,
    roofline,
)
from sam3_lora_tpu_torch.models import Batch, GeoPrompt, Targets, build_sam3_image_model, init_model
from sam3_lora_tpu_torch.models.layers import LoRALinear
from sam3_lora_tpu_torch.models.lora import trainable_parameters
from sam3_lora_tpu_torch.ops.attention import dot_product_attention
from sam3_lora_tpu_torch.ops.interpolate import resize_pil_bilinear
from sam3_lora_tpu_torch.ops.masks import mask_iou
from sam3_lora_tpu_torch.ops import nms as nms_ops
from sam3_lora_tpu_torch.ops.rle import rle_decode, rle_encode_numpy
from sam3_lora_tpu_torch.eval import writer as eval_writer
from sam3_lora_tpu_torch.ops import _cuda, attention_kernel, gemm_int8, quant, window_qkv
from sam3_lora_tpu_torch.ops import window_attention as wa
from sam3_lora_tpu_torch.ops.long_attention import (
    long_attention_packed,
    long_attention_packed_plain,
    long_attention_rope_packed,
    long_attention_rope_packed_plain,
)
from sam3_lora_tpu_torch.ops.rope import compute_axial_freqs
from sam3_lora_tpu_torch.ops.window_attention import (
    window_attention_rope_packed,
    window_attention_rope_packed_plain,
)
from sam3_lora_tpu_torch.ops.window_qkv import window_attention_qkv, window_attention_rope_qkv
from sam3_lora_tpu_torch.ops import probe_kernels
from sam3_lora_tpu_torch.probes import dma_floor, format_check, format_row, packed, window_cost
from sam3_lora_tpu_torch.interactive import interactive_ground
from sam3_lora_tpu_torch.models.decoder import TransformerDecoder
from sam3_lora_tpu_torch.models.layers import Spec
from sam3_lora_tpu_torch.predictor import SAM3InteractiveImagePredictor, tracker_core
from sam3_lora_tpu_torch.processor import Sam3Processor
from sam3_lora_tpu_torch.train.data import DataLoader, Sample
from sam3_lora_tpu_torch.train.losses import compute_losses
from sam3_lora_tpu_torch.train.prefetch import batch_to_device
from sam3_lora_tpu_torch.train.trainer import Trainer, train_step
from sam3_lora_tpu_torch.ops.association import associate_det_trk
from sam3_lora_tpu_torch.ops.cc import connected_components
from sam3_lora_tpu_torch.tracking_predictor import Sam3TrackerPredictor
from sam3_lora_tpu_torch.utils.logging import counters as program_counters
from sam3_lora_tpu_torch.video import (
    TrackState, VideoGrounder, fill_holes_in_mask_scores, make_tracker_fns, memory_bank,
    video_tracker_core,
)
from sam3_lora_tpu_torch.video_predictor import Sam3VideoPredictor
from sam3_lora_tpu_torch.agent import RuleBasedRefiner, agent_inference
from sam3_lora_tpu_torch.agent_tools import ScriptedLLM, _upsample_masks, tool_agent_inference
from sam3_lora_tpu_torch.eval import saco_veval
from sam3_lora_tpu_torch.ops.cc import sample_point_from_error_region
from sam3_lora_tpu_torch.train import video_losses
from sam3_lora_tpu_torch.train.video_data import VideoGroundingDataset, make_synthetic_ytvis

SEED = 0
LSE_ATOL = 2e-3    # natural-log units; measured 6.4e-4 (K1, bf16-rounded rotated q, k)
SMALL_TOL = 5e-2   # bf16 on the card against fp32 on the CPU, through the whole small model
# one training step of the small model, bf16 on the card against fp32 on the
# CPU: |loss - ref| <= LOSS_RTOL * |ref|, and for each adapter
# ||grad - ref|| <= GRAD_RTOL * ||ref|| (bf16 through ~20 layers and back;
# measured on an H100: loss 4.4e-4, gradients 3.3e-2 median, 5.5e-2 worst)
LOSS_RTOL = 5e-3
GRAD_RTOL = 1e-1
# the same with the small config's ViT in the int8 tier: the card quantizes
# bf16-rounded activations, the CPU fp32 ones, so some int8 values sit a step
# apart (1/127 of their row's largest entry) in each of the 16 quantized
# GEMMs, forward and back; that doubles the gradients' bound (measured on an
# H100 (700 W): 5.7e-2 median, 1.12e-1 worst, where the bf16 config gave 5.5e-2)
GRAD_RTOL_INT8 = 2e-1
# scale-out (b): the mean gradient of two halves of a batch (2 + 2 images in
# bf16 on the card, each half's loss over the group's counts) against the
# whole batch of 4's, adapter by adapter. The halves run every GEMM and
# kernel at other shapes, so every bf16 rounding moves; the same batch in
# another image order (same shapes) sits within 5.5e-4. Measured on an H100
# (700 W): 1.20e-1 at the decoder's layer-1 linear1 lora_b, 2.5e-2 median;
# all adapters as one vector are held to GRAD_RTOL, and the ranks to the
# same halves computed in one process bit for bit
GRAD_RTOL_SPLIT = 2e-1
# K5 and K6 against their plain versions: max |kernel - plain| <= GEMM_RTOL *
# max |plain|, one bf16 ulp of the largest output (the plain versions sum the
# bf16 products in another order); K4 must equal its plain version bit for bit
GEMM_RTOL = 8e-3
FWD_SOURCE = "sam3_lora_tpu_torch/csrc/attention_fwd.cu"
BWD_SOURCE = "sam3_lora_tpu_torch/csrc/attention_bwd.cu"
GEMM_SOURCE = "sam3_lora_tpu_torch/csrc/gemm_int8.cu"
PROMPTS = (["crack"], ["crack", "wall"], ["crack", "wall", "stain"])
TRAIN_BATCH = 4
TRAIN_STEPS = 4  # one warm-up, three timed
LORA = LoRAConfig(target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))
ENTRIES = (window_attention_rope_packed, long_attention_rope_packed, long_attention_packed)
# the window routes: K1', W-g and W-p with and without RoPE, W-qkv
WINDOW_ROUTES = (wa.window_attention_packed, wa.window_attention_grouped,
                 wa.window_attention_rope_grouped, wa.window_attention_pair_packed,
                 wa.window_attention_rope_pair_packed, window_attention_qkv,
                 window_attention_rope_qkv)
ATTENTION = ENTRIES + WINDOW_ROUTES
BENCH_BATCH = 8


def rope_tables(head_dim: int, side: int, scale_pos: float):
    ang = compute_axial_freqs(head_dim, side, side, scale_pos=scale_pos)
    return (torch.tensor(np.cos(ang), device="cuda"), torch.tensor(np.sin(ang), device="cuda"))


def main_path_operands(g: torch.Generator, n_images: int, n_prompts: int):
    """(entry, plain, args, replaces) of the three entry points, with the
    operands the main path hands them: q/k/v of the ViT are strided views of
    the (N, L, 3*1024) qkv projection, 16 heads x 64; the fusion encoder's
    are (B_prompts, 5184, 256), 8 heads x 32."""

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    cfg = ModelConfig()
    d, dh, feat, ws = cfg.vit_dim, cfg.vit_dim // cfg.vit_heads, cfg.feat_size, cfg.vit_window_size
    n_win = (feat // ws) ** 2 * n_images
    cases = []
    qkv = randn(n_win, ws * ws, 3 * d)
    cos, sin = rope_tables(dh, ws, 1.0)
    args = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], dh ** -0.5, cos, sin)
    cases.append((window_attention_rope_packed, window_attention_rope_packed_plain, args,
                  "sam3_lora_tpu/ops/window_attention.py:663"))
    qkv = randn(n_images, feat * feat, 3 * d)
    cos, sin = rope_tables(dh, feat, ws / feat)
    args = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], dh ** -0.5, dh, cos, sin)
    cases.append((long_attention_rope_packed, long_attention_rope_packed_plain, args,
                  "sam3_lora_tpu/ops/long_attention.py:427"))
    e, edh = cfg.d_model, cfg.d_model // cfg.enc_heads
    args = (randn(n_prompts, feat * feat, e), randn(n_prompts, feat * feat, e),
            randn(n_prompts, feat * feat, e), edh ** -0.5, edh)
    cases.append((long_attention_packed, long_attention_packed_plain, args,
                  "sam3_lora_tpu/ops/long_attention.py:406"))
    return cases


def _split(entry, args):
    """Entry-point arguments -> (q, k, v, scale, head_dim, cos, sin)."""
    if entry is window_attention_rope_packed:
        q, k, v, scale, cos, sin = args
        return q, k, v, scale, 2 * cos.shape[-1], cos, sin
    if entry is long_attention_rope_packed:
        return args
    return (*args, None, None)


def sdpa_operands(qh, kh, vh, cos, sin):
    """(N, P, L, dh) contiguous q, k (rotated) and v, from (N, P, L, dh)
    views, for the library's scaled_dot_product_attention."""
    if cos is not None:
        qh, kh = (attention_kernel.apply_rope_half(t, cos, sin) for t in (qh, kh))
    return qh.contiguous(), kh.contiguous(), vh.contiguous()


def sdpa_heads(q, k, v, head_dim, cos, sin):
    """``sdpa_operands`` of packed (N, L, P*dh) operands."""
    return sdpa_operands(*(attention_kernel._heads(t, head_dim) for t in (q, k, v)), cos, sin)


def phase_kernels(g: torch.Generator, n_prompts: int):
    rows, failed = [], []
    for entry, plain, args, replaces in main_path_operands(g, 1, n_prompts):
        out = entry(*args)
        again = entry(*args)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        if not same:
            failed.append(f"{entry.__name__}: two launches differ")
        ref = plain(*args)
        err = (out.float() - ref.float()).abs().max().item()
        bound = KERNEL_RTOL * ref.float().abs().max().item()
        del out, again
        ms = median_ms(lambda: entry(*args))
        plain_ms = median_ms(lambda: plain(*args), reps=5)
        q, k, v, scale, dh, cos, sin = _split(entry, args)
        ops, nbytes = attention_work(q.shape[0] * q.shape[2] // dh, q.shape[1], dh, False)
        bound_ms, bound_by = roofline(ops / PEAK_BF16, nbytes)
        qh, kh, vh = sdpa_heads(q, k, v, dh, cos, sin)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        del qh, kh, vh
        print(f"kernel {entry.__name__} q{tuple(args[0].shape)} stride{args[0].stride()}: "
              f"max_abs_err {err:.3e} (bound {bound:.3e} = {KERNEL_RTOL} x max|plain|), two "
              f"launches equal {same}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, roofline "
              f"{bound_ms:.4f} ms ({bound_by}; share {bound_ms / ms:.3f}), "
              f"scaled_dot_product_attention {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)", flush=True)
        if not err <= bound:
            failed.append(f"{entry.__name__}: max abs err {err:.3e} > {bound:.3e}")
        rows.append({"name": entry.__name__, "route": "cuda", "source": FWD_SOURCE,
                     "replaces": replaces, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
        if entry is window_attention_rope_packed:
            rows.append(rope_row(q, k, dh, cos, sin, failed))
    bwd_rows, bwd_failed = phase_backward_kernels(g)
    route_rows, route_failed = phase_window_route_kernels(g)
    gemm_rows, gemm_failed = phase_gemm_kernels(g)
    if failed + bwd_failed + route_failed + gemm_failed:
        raise AssertionError("; ".join(failed + bwd_failed + route_failed + gemm_failed))
    return rows + bwd_rows + route_rows + gemm_rows


def rope_row(q, k, dh, cos, sin, failed: list) -> dict:
    """The forward's rotation pass on K1's operands (packed qkv column
    views): bit for bit its plain version, timed; its bound is the bytes it
    must move (q, k and the tables read, their rotation written)."""
    qh, kh = (attention_kernel._heads(t, dh) for t in (q, k))
    got = attention_kernel.rope_cuda(qh, kh, cos, sin)
    torch.cuda.synchronize()
    refs = attention_kernel.rope_plain(qh, kh, cos, sin)
    same = all(torch.equal(a, b) for a, b in zip(got, refs))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, refs))
    if not same:
        failed.append(f"attention_rope: differs from rope_plain by {err:.3e}")
    ms = median_ms(lambda: attention_kernel.rope_cuda(qh, kh, cos, sin, *got))
    plain_ms = median_ms(lambda: attention_kernel.rope_plain(qh, kh, cos, sin), reps=5)
    nbytes = 4 * qh.numel() * qh.element_size() + 2 * cos.numel() * cos.element_size()
    bound_ms, bound_by = roofline(0.0, nbytes)
    print(f"kernel attention_rope q{tuple(qh.shape)} stride{qh.stride()}: bit for bit equal "
          f"{same} (max_abs_err {err:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"roofline {bound_ms:.4f} ms ({bound_by}; share {bound_ms / ms:.3f}), no library "
          f"call", flush=True)
    return {"name": "attention_rope", "route": "cuda", "source": FWD_SOURCE,
            "replaces": "sam3_lora_tpu/ops/window_attention.py:411", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


BWD_REPLACES = {
    "window_attention_rope_packed": "sam3_lora_tpu/ops/window_attention.py:445",
    "long_attention_rope_packed": "sam3_lora_tpu/ops/long_attention.py:218",
    "long_attention_packed": "sam3_lora_tpu/ops/long_attention.py:218",
}


def bwd_bounds(heads: int, l: int, dh: int, ms: float):
    """(bound_ms, bound_by, floor_ms, text) of one backward call: the roofline
    bound on measure.attention_work's 5 products, the 7-product floor the
    two-pass design computes (S and dP formed in both passes), and both
    shares of the kernel's ``ms``."""
    ops, nbytes = attention_work(heads, l, dh, True)
    bound_ms, bound_by = roofline(ops / PEAK_BF16, nbytes)
    floor_ms = roofline(1.4 * ops / PEAK_BF16, nbytes)[0]
    text = (f"roofline {bound_ms:.4f} ms ({bound_by}; share {bound_ms / ms:.3f}), 7-product "
            f"floor {floor_ms:.4f} ms (share {floor_ms / ms:.3f})")
    return bound_ms, bound_by, floor_ms, text


def check_deterministic(tag: str, first, second, failed: list) -> bool:
    """Two launches of a backward on the same operands give the same bits."""
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    if not same:
        failed.append(f"{tag} backward: two launches differ")
    return same


def phase_backward_kernels(g: torch.Generator):
    """The backward kernels on the training path's operands at batch 4 (and
    4 prompts): the forward with its log-sum-exp, then dq/dk/dv from the
    kernels against the plain backward; returns (rows, failures)."""
    rows, failed = [], []
    for entry, _, args, _ in main_path_operands(g, TRAIN_BATCH, TRAIN_BATCH):
        q, k, v, scale, dh, cos, sin = _split(entry, args)
        o, lse = attention_kernel.attention_packed_cuda(q, k, v, scale, dh, cos, sin, with_lse=True)
        do = torch.randn(o.shape, generator=g, device="cuda").to(torch.bfloat16)
        grads = attention_kernel.attention_packed_bwd_cuda(q, k, v, o, lse, do, scale, dh, cos, sin)
        again = attention_kernel.attention_packed_bwd_cuda(q, k, v, o, lse, do, scale, dh, cos, sin)
        torch.cuda.synchronize()
        same = check_deterministic(entry.__name__, grads, again, failed)
        del again
        refs = attention_kernel.attention_packed_bwd_plain(q, k, v, o, do, scale, dh, cos, sin)
        qh, kh = (attention_kernel._heads(t, dh) for t in (q, k))
        if cos is not None:
            qh, kh = (attention_kernel.apply_rope_half(t, cos, sin) for t in (qh, kh))
        lse_ref = torch.logsumexp(torch.einsum("npqd,npkd->npqk", qh.float(), kh.float()) * scale, -1)
        lse_err = (lse - lse_ref).abs().max().item()
        del qh, kh, lse_ref
        errs, parts = [], []
        for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
            err = (a.float() - b.float()).abs().max().item()
            bound = KERNEL_BWD_RTOL * b.float().abs().max().item()
            errs.append(err)
            parts.append(f"{name} {err:.3e} (bound {bound:.3e})")
            if not err <= bound:
                failed.append(f"{entry.__name__} backward {name}: max abs err {err:.3e} > {bound:.3e}")
        if not lse_err <= LSE_ATOL:
            failed.append(f"{entry.__name__} lse: max abs err {lse_err:.3e} > {LSE_ATOL}")
        del grads, refs
        ms = median_ms(lambda: attention_kernel.attention_packed_bwd_cuda(
            q, k, v, o, lse, do, scale, dh, cos, sin))
        plain_ms = median_ms(lambda: attention_kernel.attention_packed_bwd_plain(
            q, k, v, o, do, scale, dh, cos, sin), reps=3)
        heads = q.shape[0] * q.shape[2] // dh
        bound_ms, bound_by, _, bounds = bwd_bounds(heads, q.shape[1], dh, ms)
        # the library's backward on the rotated operands: autograd of one
        # scaled_dot_product_attention call, its forward outside the timing
        qh, kh, vh = (t.requires_grad_(True) for t in sdpa_heads(q, k, v, dh, cos, sin))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        doh = attention_kernel._heads(do, dh).contiguous()
        lib_ms = median_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                       retain_graph=True))
        del qh, kh, vh, lib_out, doh
        torch.cuda.empty_cache()
        print(f"kernel {entry.__name__} backward q{tuple(q.shape)} stride{q.stride()}: "
              f"max_abs_err {', '.join(parts)} ({KERNEL_BWD_RTOL} x max|plain|), lse {lse_err:.3e} "
              f"(bound {LSE_ATOL}), two launches equal {same}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {bounds}, scaled_dot_product_attention backward "
              f"{lib_ms:.4f} ms", flush=True)
        rows.append({"name": entry.__name__ + "_bwd", "route": "cuda", "source": BWD_SOURCE,
                     "replaces": BWD_REPLACES[entry.__name__], "launches": 0,
                     "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    return rows, failed


WA, WQ = "sam3_lora_tpu/ops/window_attention.py", "sam3_lora_tpu/ops/window_qkv.py"
ROUTE_REPLACES = {  # (forward, backward) TPU kernel of each window route
    "window_attention_packed": (f"{WA}:639", f"{WA}:426"),
    "window_attention_grouped": (f"{WA}:507", f"{WA}:507"),
    "window_attention_rope_grouped": (f"{WA}:507", f"{WA}:507"),
    "window_attention_pair_packed": (f"{WA}:584", f"{WA}:584"),
    "window_attention_rope_pair_packed": (f"{WA}:584", f"{WA}:584"),
    "window_attention_qkv": (f"{WQ}:178", f"{WQ}:208"),
    "window_attention_rope_qkv": (f"{WQ}:178", f"{WQ}:208"),
}


class RouteOperands:
    """One window route's operands at ``n_images`` images (9 windows of 576
    tokens each, 16 heads x 64) as the ViT hands them: ``args`` for the entry
    (W-qkv: the (N, L, 3072) qkv projection output; W-g, W-p: (N, 16, L, 64)
    views of it; K1': (N*8, L, 128) head pairs, as the JAX packed chain lays
    them out), ``views`` the (N', P, L, 64) q, k, v the kernel reads,
    ``to_views`` the map of the entry's output (and gradients) to that
    layout."""

    def __init__(self, g: torch.Generator, entry, n_images: int):
        cfg = ModelConfig()
        d, heads, ws = cfg.vit_dim, cfg.vit_heads, cfg.vit_window_size
        dh, l = d // heads, ws * ws
        n = (cfg.feat_size // ws) ** 2 * n_images
        self.qkv = torch.randn(n, l, 3 * d, generator=g, device="cuda").to(torch.bfloat16)
        rope = "rope" in entry.__name__
        self.cos, self.sin = rope_tables(dh, ws, 1.0) if rope else (None, None)
        tables = (self.cos, self.sin) if rope else ()
        self.scale = dh ** -0.5
        heads4 = functools.partial(attention_kernel._heads, head_dim=dh)
        self.out_shape = (n, heads, l, dh)
        self.on_qkv = entry in (window_attention_qkv, window_attention_rope_qkv)
        if self.on_qkv:
            self.args = (self.qkv, heads, self.scale, *tables)
            self.views, self.to_views = [heads4(t) for t in self.qkv.chunk(3, -1)], heads4
            self.out_shape = (n, l, d)
        elif entry is wa.window_attention_packed:
            pairs = [t.reshape(n, l, heads // 2, 2 * dh).transpose(1, 2).reshape(-1, l, 2 * dh)
                     .contiguous() for t in self.qkv.chunk(3, -1)]
            self.args = (*pairs, self.scale)
            self.views, self.to_views = [heads4(t) for t in pairs], heads4
            self.out_shape = pairs[0].shape
        else:
            views = self.qkv.reshape(n, l, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
            self.args = (*views, self.scale, *tables)
            pair = entry in (wa.window_attention_pair_packed, wa.window_attention_rope_pair_packed)
            # W-p: the head-pair view copies the strided views (the relayout)
            self.to_views = wa._pairs if pair else (lambda t: t)
            self.views = [self.to_views(t) for t in views]

    def buffers(self, n: int):
        """``n`` new outputs in the entry's layout, as kernel views; the
        W-qkv gradients are the column blocks of one (N, L, 3072) tensor."""
        if self.on_qkv and n == 3:
            return [self.to_views(t) for t in torch.empty_like(self.qkv).chunk(3, -1)]
        return [self.to_views(torch.empty(self.out_shape, dtype=torch.bfloat16, device="cuda"))
                for _ in range(n)]


def phase_window_route_kernels(g: torch.Generator):
    """K1', W-g, W-p and W-qkv: the forward through each entry at serving's
    operands (one image), the backward kernels on each route's layout at
    batch 8, against the plain versions; returns (rows, failures)."""
    rows, failed = [], []
    ak = attention_kernel
    for entry in WINDOW_ROUTES:
        name = entry.__name__
        op = RouteOperands(g, entry, 1)
        out = entry(*op.args)
        again = entry(*op.args)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        if not same:
            failed.append(f"{name}: two launches differ")
        ref = ak.attention_plain(*op.views, op.scale, op.cos, op.sin)
        err = (op.to_views(out).float() - ref.float()).abs().max().item()
        bound = KERNEL_RTOL * ref.float().abs().max().item()
        del again
        ms = median_ms(lambda: entry(*op.args))
        plain_ms = median_ms(lambda: ak.attention_plain(*op.views, op.scale, op.cos, op.sin), reps=5)
        n, p, l, dh = op.views[0].shape
        ops, nbytes = attention_work(n * p, l, dh, False)
        bound_ms, bound_by = roofline(ops / PEAK_BF16, nbytes)
        qh, kh, vh = sdpa_operands(*op.views, op.cos, op.sin)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=op.scale))
        del qh, kh, vh, out, ref
        print(f"kernel {name} q{tuple(op.views[0].shape)} stride{op.views[0].stride()}: "
              f"max_abs_err {err:.3e} (bound {bound:.3e} = {KERNEL_RTOL} x max|plain|), two "
              f"launches equal {same}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, roofline "
              f"{bound_ms:.4f} ms ({bound_by}; share {bound_ms / ms:.3f}), "
              f"scaled_dot_product_attention {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)", flush=True)
        if not err <= bound:
            failed.append(f"{name}: max abs err {err:.3e} > {bound:.3e}")
        rows.append({"name": name, "route": "cuda", "source": FWD_SOURCE,
                     "replaces": ROUTE_REPLACES[name][0], "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})

        op = RouteOperands(g, entry, BENCH_BATCH)
        q, k, v = op.views
        o = op.buffers(1)[0]
        _, lse = ak.attention_cuda(q, k, v, op.scale, op.cos, op.sin, o=o, with_lse=True)
        do = torch.randn(o.shape, generator=g, device="cuda").to(torch.bfloat16)
        bufs = op.buffers(3)
        grads = ak.attention_bwd_cuda(q, k, v, o, lse, do, op.scale, op.cos, op.sin, out=bufs)
        grads = [t.clone() for t in grads]
        again = ak.attention_bwd_cuda(q, k, v, o, lse, do, op.scale, op.cos, op.sin, out=bufs)
        torch.cuda.synchronize()
        same = check_deterministic(name, grads, again, failed)
        refs = ak.attention_bwd_plain(q, k, v, o, do, op.scale, op.cos, op.sin)
        errs, parts = [], []
        for gname, a, b in zip(("dq", "dk", "dv"), grads, refs):
            e = (a.float() - b.float()).abs().max().item()
            bnd = KERNEL_BWD_RTOL * b.float().abs().max().item()
            errs.append(e)
            parts.append(f"{gname} {e:.3e} (bound {bnd:.3e})")
            if not e <= bnd:
                failed.append(f"{name} backward {gname}: max abs err {e:.3e} > {bnd:.3e}")
        del grads, again, refs
        ms = median_ms(lambda: ak.attention_bwd_cuda(q, k, v, o, lse, do, op.scale, op.cos,
                                                     op.sin, out=bufs))
        plain_ms = median_ms(lambda: ak.attention_bwd_plain(q, k, v, o, do, op.scale, op.cos,
                                                            op.sin), reps=3)
        n, p, l, dh = q.shape
        bound_ms, bound_by, _, bounds = bwd_bounds(n * p, l, dh, ms)
        qh, kh, vh = (t.requires_grad_(True) for t in sdpa_operands(q, k, v, op.cos, op.sin))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=op.scale)
        doh = do.contiguous()
        lib_ms = median_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                       retain_graph=True))
        del qh, kh, vh, lib_out, doh, op, o, lse, do, bufs
        torch.cuda.empty_cache()
        print(f"kernel {name} backward q{tuple(q.shape)} stride{q.stride()}: max_abs_err "
              f"{', '.join(parts)} ({KERNEL_BWD_RTOL} x max|plain|), two launches equal {same}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {bounds}, "
              f"scaled_dot_product_attention backward {lib_ms:.4f} ms", flush=True)
        rows.append({"name": name + "_bwd", "route": "cuda", "source": BWD_SOURCE,
                     "replaces": ROUTE_REPLACES[name][1], "launches": 0, "max_abs_err": max(errs),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})
    return rows, failed


GEMM_REPLACES = {
    "int8_gemm_wres": "sam3_lora_tpu/ops/gemm_int8.py:246",
    "int8_lora_gemm_wres": "sam3_lora_tpu/ops/gemm_int8.py:151",
    "bf16_gemm_wres_nt": "sam3_lora_tpu/ops/gemm_int8.py:218",
}
GEMM_ENTRIES = (gemm_int8.int8_gemm_wres, gemm_int8.int8_lora_gemm_wres, gemm_int8.bf16_gemm_wres_nt)
GEMM_ROW_CASE = {"int8_gemm_wres": ("fc1", "train"), "int8_lora_gemm_wres": ("fc1", "serve"),
                 "bf16_gemm_wres_nt": ("fc1", "train")}


def gemm_cases():
    """(layer, path, M, K, N) of the int8 GEMMs on the main paths: the ViT's
    at M = 5184 tokens (serving, one image), 4 x 5184 (training, batch 4)
    and 8 x 5184 (bench.py's batch), the text encoder's at 3 prompts x 32
    tokens, and a ragged M."""
    cfg = ModelConfig()
    d, hid, w = cfg.vit_dim, cfg.vit_mlp_hidden, cfg.text_width
    vit = {"qkv": (d, 3 * d), "proj": (d, d), "fc1": (d, hid), "fc2": (hid, d)}
    text = {"out_proj": (w, w), "c_fc": (w, 4 * w), "c_proj": (4 * w, w)}
    tokens = cfg.feat_size ** 2
    cases = [(name, path, m, k, n) for path, m in (("serve", tokens), ("train", TRAIN_BATCH * tokens),
                                                   ("bench", BENCH_BATCH * tokens))
             for name, (k, n) in vit.items()]
    cases += [(name, "text", len(PROMPTS[-1]) * cfg.text_context_length, k, n)
              for name, (k, n) in text.items()]
    return cases + [("fc1", "ragged", 1000, d, hid)]


K5_RANKS = (32, 64)  # besides LORA.rank, at fc1 serving: bench_lora_config's rank and MAX_RANK


def unfused_chain(x, wq, ws, a, b, scale: float) -> torch.Tensor:
    """The route ``LoRALinear.forward`` takes with GEMM_LORA_FUSED off: K4,
    then the adapter products in x's dtype (the second in fp32, as the
    layer runs it) and the add."""
    delta = F.linear(F.linear(x, a).float(), b.float()) * scale
    return gemm_int8.int8_gemm_wres(x, wq, ws) + delta.to(x.dtype)


def phase_gemm_kernels(g: torch.Generator):
    """K4 (every case), K5 (the serving, training and ragged ViT cases at
    rank 8, fc1 serving also at ranks 32 and 64) and K6 (the ViT cases) on
    the main path's shapes against their plain versions; each K5 line also
    times the unfused chain and reads K5 against K4 of the same shape, the
    two timed in turns (``paired_ms``: one call's host time is part of its
    event time, and the host's pace drifts within a run).
    Returns (one JSON row per kernel at GEMM_ROW_CASE, failures)."""
    rows, failed = {}, []
    for layer, path, m, k, n in gemm_cases():
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        wq, ws = quant.quantize_weight(torch.randn(n, k, generator=g, device="cuda") / k ** 0.5)
        dy = torch.randn(m, n, generator=g, device="cuda").to(torch.bfloat16)
        w_deq = gemm_int8.dequantize(wq, ws, torch.bfloat16)
        xq = gemm_int8.quant_rows(x)[0]
        yard = {"int_mm_ms": median_ms(lambda: torch._int_mm(xq, wq.t())) if m > 16 else None,
                "bf16_mm_ms": median_ms(lambda: torch.matmul(x, w_deq.t()))}
        calls = [("int8_gemm_wres", (x, wq, ws), gemm_int8.int8_gemm_wres_plain,
                  2.0 * m * k * n / PEAK_INT8, m * k * 2 + n * k + n * 4 + m * n * 2, None)]
        if path in ("serve", "train", "ragged"):
            ranks = (LORA.rank,) + (K5_RANKS if (layer, path) == ("fc1", "serve") else ())
            for rank in ranks:
                a = (torch.randn(rank, k, generator=g, device="cuda") / k ** 0.5).to(torch.bfloat16)
                b = (0.02 * torch.randn(n, rank, generator=g, device="cuda")).to(torch.bfloat16)
                calls.append(("int8_lora_gemm_wres", (x, wq, ws, a, b, LORA.scaling),
                              gemm_int8.int8_lora_gemm_wres_plain,
                              2.0 * m * k * n / PEAK_INT8 + 2.0 * m * rank * (k + n) / PEAK_BF16,
                              m * k * 2 + n * k + n * 4 + rank * (k + n) * 2 + m * n * 2, None))
        if path != "text":
            calls.append(("bf16_gemm_wres_nt", (dy, wq, ws), gemm_int8.bf16_gemm_wres_nt_plain,
                          2.0 * m * k * n / PEAK_BF16, m * n * 2 + n * k + n * 4 + m * k * 2,
                          lambda: torch.matmul(dy, w_deq)))
        for name, args, plain, t_ops, nbytes, library in calls:
            entry = getattr(gemm_int8, name)
            out = entry(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            ref_max = ref.float().abs().max().item()
            lora = name == "int8_lora_gemm_wres"
            if name == "int8_gemm_wres":
                ok, limit = torch.equal(out, ref), "bit-exact"
            else:
                ok, limit = err <= GEMM_RTOL * ref_max, f"bound {GEMM_RTOL * ref_max:.3e}"
            if lora:  # a second launch gives the same bits; K4 of the shape timed in turns
                same = torch.equal(out, entry(*args))
                ok, limit = ok and same, f"{limit}; two launches equal {same}"
                k4_ms, ms = paired_ms(lambda: gemm_int8.int8_gemm_wres(x, wq, ws),
                                      lambda: entry(*args))
            else:
                ms = median_ms(lambda: entry(*args))
            plain_ms = median_ms(lambda: plain(*args), reps=3)
            bound_ms, bound_by = roofline(t_ops, nbytes)
            lib_ms = median_ms(library) if library is not None else None
            extra = {}
            if lib_ms is not None:
                text = f"torch.matmul(dy, w_deq) {lib_ms:.4f} ms"
            else:
                int_mm = yard["int_mm_ms"]
                text = ("yardsticks (not the same function): torch._int_mm "
                        + ("n/a (M <= 16)" if int_mm is None else f"{int_mm:.4f} ms")
                        + f", bf16 torch.matmul {yard['bf16_mm_ms']:.4f} ms")
            rank = f" rank {args[3].shape[0]}" if lora else ""
            if lora:
                extra = {"unfused_ms": median_ms(lambda: unfused_chain(*args)), "k4_ms": k4_ms}
                text += (f"; unfused chain (K4 + F.linear x2 + add) "
                         f"{extra['unfused_ms']:.4f} ms, "
                         f"K4 in turns with K5 {k4_ms:.4f} ms, K5/K4 {ms / k4_ms:.3f}, "
                         f"K5/unfused {ms / extra['unfused_ms']:.3f}")
            print(f"kernel {name} {layer} ({path}) M={m} K={k} N={n}{rank}: max_abs_err {err:.3e} "
                  f"({limit}{'' if ok else ' FAILED'}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"roofline {bound_ms:.4f} ms ({bound_by}), {text}", flush=True)
            if not ok:
                failed.append(f"{name} {layer} M={m}{rank}: max abs err {err:.3e} ({limit})")
            if GEMM_ROW_CASE[name] == (layer, path) and name not in rows:
                rows[name] = {"name": name, "route": "cuda", "source": GEMM_SOURCE,
                              "replaces": GEMM_REPLACES[name], "launches": 0, "max_abs_err": err,
                              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": lib_ms,
                              "shape": f"{layer} M={m} K={k} N={n}{rank}",
                              **({} if lib_ms is not None else yard), **extra}
            del out, ref, diff
        del x, wq, ws, dy, w_deq, xq, calls
        torch.cuda.empty_cache()
    return [rows[e.__name__] for e in GEMM_ENTRIES], failed


_PROGRAM0: dict = {}


def reset_counts():
    """Every kernel entry's launch counter to 0; the graph cache's counters
    read from here on (``graph_delta``)."""
    global _PROGRAM0
    for entry in ATTENTION:
        entry.launches = entry.bwd_launches = 0
    for entry in GEMM_ENTRIES:
        entry.launches = 0
    attention_kernel.rope_cuda.launches = 0
    _PROGRAM0 = program_counters()


def graph_delta() -> dict:
    """The graph cache's counters since reset_counts (``graphs.py``):
    ``graph_replays``, ``graph_captures`` and ``graph_captures.<unit>``."""
    return {k: v - _PROGRAM0.get(k, 0) for k, v in program_counters().items()
            if k.startswith("graph_")}


def served(calls: int, backbone: dict = None, ground: dict = None, delta: dict = None) -> dict:
    """The launches the kernel entries count for ``calls`` serving calls
    since reset_counts (or over ``delta``, a graph_delta), each running the
    units given once: an image's ``backbone``, a ``ground``ing (each the
    launches of one run, by entry). With a card each unit comes from its
    graph (``graphs.py``): its launches twice for each graph of the unit
    captured (the eager warm-up and the capture), none for a replay (the
    graph launches the kernels, through no entry); without one the calls
    run them eagerly. Raises unless every unit of every call replayed."""
    units = {u: v for u, v in (("backbone", backbone), ("ground", ground)) if v is not None}
    d = graph_delta() if delta is None else delta
    graphs = torch.cuda.is_available()
    replays = calls * len(units) if graphs else 0
    if d.get("graph_replays", 0) != replays:
        raise AssertionError(f"{d.get('graph_replays', 0)} graph replays, expected {replays}")
    want = collections.Counter()
    for unit, design in units.items():
        runs = 2 * d.get(f"graph_captures.{unit}", 0) if graphs else calls
        for k, v in design.items():
            want[k] += runs * v
    return dict(want)


@torch.inference_mode()
def eager_outputs(engine, images: torch.Tensor, ids: torch.Tensor, geo=None):
    """``head_outputs`` of the model's own forward (no graph), batched as
    ``engine._forward`` batches it: one image (1, 3, R, R) under every
    prompt of ``ids`` (n, T), or image i under prompt i."""
    n = ids.shape[0]
    img_ids = (torch.arange if images.shape[0] == n else torch.zeros)(n, dtype=torch.long,
                                                                      device=ids.device)
    geo = GeoPrompt.empty(n, engine.cfg.max_prompt_boxes, device=ids.device) if geo is None else geo
    return head_outputs(engine.model(Batch(images=images, token_ids=ids, img_ids=img_ids,
                                           geo=geo)))


def as_eager(tag: str, got, eager) -> list:
    """``got`` (raw outputs from the graphs) bit for bit ``eager()``'s, where
    two eager runs agree bit for bit, else within their own spread; returns
    the largest differences from the first eager run."""
    a, b = eager(), eager()
    diffs = [(g.float() - x.float()).abs().max().item() for g, x in zip(got, a)]
    for g, x, y, d in zip(got, a, b, diffs):
        spread = 0.0 if torch.equal(x, y) else (x.float() - y.float()).abs().max().item()
        if g.shape != x.shape or not (torch.equal(g, x) if spread == 0.0 else d <= spread):
            raise AssertionError(f"{tag}: replayed outputs differ from the eager forward's by "
                                 f"{diffs} (eager against itself {spread})")
    return diffs


def device_launches(fn) -> dict:
    """{kernel name: launches} of ``fn()`` from the device trace."""
    return {name: n for name, (_, n) in profile_step(fn)["kernels"].items()}


# the port's own kernels (csrc/) by the names the profiler gives them
PORT_KERNELS = ("attention_fwd_kernel", "rope_kernel", "gemm_kernel", "quant_rows_kernel",
                "lora_prep_kernel", "dequant_t_kernel")
# traces of a replay taken before one that lacks no kernel counts as a miss:
# the profiler has dropped a replayed graph's kernel records (2 of 32 once)
TRACE_TRIES = 3


def same_kernels(tag: str, replay, eager) -> int:
    """``replay()`` (a call from the graphs) launches the port's own kernels
    (PORT_KERNELS) as ``eager()`` does, name by name and count by count, in
    one of TRACE_TRIES device traces (cuBLAS and cuDNN may pick other kernels
    of theirs under capture); returns how many."""
    def own(fn):
        return {k: n for k, n in device_launches(fn).items() if any(p in k for p in PORT_KERNELS)}

    want, seen = own(eager), []
    for _ in range(TRACE_TRIES):
        seen.append(own(replay))
        if seen[-1] == want and want:
            break
    else:
        names = set(want).union(*seen)
        raise AssertionError(f"{tag}: the port's kernels replayed differ from eager's in "
                             f"{TRACE_TRIES} traces: "
                             f"{ {k: (want.get(k, 0), [d.get(k, 0) for d in seen]) for k in names} }")
    if len(seen) > 1:
        print(f"{tag}: {len(seen) - 1} trace(s) of the replay lacked kernels the next one had: "
              f"{[sum(d.values()) for d in seen]} against eager's {sum(want.values())}",
              flush=True)
    return sum(want.values())


def counts():
    """Every kernel's launches since reset_counts: the attention entries'
    forward (and backward, as <name>_bwd), the forward's rotation pass
    (attention_rope) and K4/K5/K6."""
    out = {e.__name__: e.launches for e in ATTENTION}
    out.update({e.__name__ + "_bwd": e.bwd_launches for e in ATTENTION})
    out["attention_rope"] = attention_kernel.rope_cuda.launches
    out.update({e.__name__: e.launches for e in GEMM_ENTRIES})
    return out


def with_rope(want: dict) -> dict:
    """``want`` with the rotation pass's launches: one per forward of an
    entry with RoPE."""
    rope = sum(v for k, v in want.items() if "rope" in k and not k.endswith("_bwd"))
    return {**want, "attention_rope": rope}


def model_config(int8: bool) -> ModelConfig:
    return ModelConfig(dtype="bfloat16", base_quant="int8" if int8 else "none")


def live_adapters(model: torch.nn.Module, g: torch.Generator, std: float = 0.02) -> int:
    """Draw every adapter's ``lora_b`` from ``g`` with deviation ``std``
    (zero at init, when the adapter branch adds nothing), so that the branch
    is live; returns how many adapters there are."""
    n = 0
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LoRALinear) and m.lora_b is not None:
                m.lora_b.normal_(0.0, std, generator=g)
                n += 1
    return n


# K5's kernels by the name the profiler gives them: the first pass (row
# quantization and xa) and the mainloop with the low-rank step
K5_KERNELS = {"first pass": "lora_prep_kernel", "mainloop": "S8ScaledLoRA"}


def k5_request_profile(tag: str, request, vit_depth: int) -> dict:
    """One request under torch.profiler: K5's device ms by kernel, its
    share of the request's device time, and the busy share."""
    prof = profile_step(request)
    parts = {key: [0.0, 0] for key in K5_KERNELS}
    for name, (ms, n) in prof["kernels"].items():
        for key, sub in K5_KERNELS.items():
            if sub in name:
                parts[key][0] += ms
                parts[key][1] += n
    total = sum(ms for ms, _ in parts.values())
    split = ", ".join(f"{key} {ms:.4f} ms in {n}" for key, (ms, n) in parts.items())
    print(f"{tag} profile (one request, {PROMPTS[0]}, torch.profiler): K5 {total:.4f} device ms "
          f"({split}), {total / prof['device_ms']:.4f} of the request's {prof['device_ms']:.3f} "
          f"device ms in a {prof['window_ms']:.3f} ms window, busy share "
          f"{prof['busy_share']:.4f}", flush=True)
    if any(n != 3 * vit_depth for _, n in parts.values()):
        raise AssertionError(f"{tag} profile: K5 kernels {parts}, expected {3 * vit_depth} each")
    return {key: ms for key, (ms, _) in parts.items()}


def phase_slice(g: torch.Generator, int8: bool = False):
    """Serving at the full config; with ``int8`` the base is in the int8 tier
    and GEMM_LORA_FUSED is on. The model's own forward (eager) of each of
    PROMPTS first; then ``_forward`` captures a graph a unit and prompt
    count (the launch counters twice the design's for each capture, the
    capture's host ms, the pool's bytes) and replays them: each bit for bit
    the eager forward; a replayed request's device kernels the eager one's
    (the device trace). Then ``predict`` of PROMPTS from the graphs (no
    entry launches, two replays a request). Returns (launches of the
    captures, latencies, peak bytes)."""
    tag = "slice-int8" if int8 else "slice"
    gemm_int8.GEMM_LORA_FUSED = int8
    t0 = time.perf_counter()
    engine = SAM3LoRAInference(model_config(int8), LORA, seed=SEED, device="cuda")
    n_adapters = live_adapters(engine.model, g)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    n_int8 = sum(p.dtype == torch.int8 for p in engine.model.parameters())
    print(f"{tag}: built {n_params} params ({n_adapters} adapters, {n_int8} int8 weights) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cfg = engine.cfg
    n_req = len(PROMPTS)
    backbone, ground = set_image_launches(cfg), prompt_launches(cfg)

    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    x = torch.from_numpy(engine.preprocess(image)[0]).cuda()
    ids = [torch.from_numpy(np.asarray(engine.tokenizer(p, context_length=cfg.text_context_length),
                                       np.int64)).cuda() for p in PROMPTS]
    for t in ids:  # first calls, eager: allocator, cuDNN and kernel set-up
        eager_outputs(engine, x, t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    reset_counts()
    first = [host_seconds(lambda: engine._forward(x, t)) for t in ids]
    launches = counts()
    check_launches(f"{tag} captures", launches, served(n_req, backbone, ground))
    pool = torch.cuda.max_memory_allocated() - m0
    replay_s = [host_seconds(lambda: engine._forward(x, t))[1] for t in ids]
    diffs = [as_eager(f"{tag} {len(p)} prompts", out, lambda: eager_outputs(engine, x, t))
             for (out, _), t, p in zip(first, ids, PROMPTS)]
    eager_k = device_launches(lambda: eager_outputs(engine, x, ids[1]))
    graph_k = device_launches(lambda: engine._forward(x, ids[1]))
    own = same_kernels(f"{tag} {len(PROMPTS[1])} prompts", lambda: engine._forward(x, ids[1]),
                       lambda: eager_outputs(engine, x, ids[1]))
    print(f"{tag}: graphs of {[len(p) for p in PROMPTS]} prompts: first call (eager warm-up and "
          f"capture) host s {[round(s_, 4) for _, s_ in first]}, replay "
          f"{[round(s_, 4) for s_ in replay_s]}; graph pool {pool} bytes "
          f"(max_memory_allocated over the captures); replays bit for bit the eager forward "
          f"(max |replay - eager| {diffs}); a {len(PROMPTS[1])}-prompt request's device kernels, "
          f"eager {sum(eager_k.values())}, replayed {sum(graph_k.values())}, the port's own "
          f"{own} of them alike (the device trace); launches of the captures "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    latencies = []
    for prompts in PROMPTS:
        t0 = time.perf_counter()
        results = engine.predict(image, prompts)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        if sorted(results) != list(range(len(prompts))):
            raise AssertionError(f"predict returned keys {sorted(results)}")
        for res in results.values():
            n = res["num_detections"]
            if n and (res["boxes"].shape != (n, 4) or res["masks"].shape != (n, 900, 1200)
                      or not np.isfinite(res["boxes"]).all()
                      or not np.isfinite(res["scores"]).all()):
                raise AssertionError(f"bad detections for {res['prompt']!r}")
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag}: latency per request (s) {[round(t, 4) for t in latencies]} for "
          f"{[len(p) for p in PROMPTS]} prompts, peak {peak / 2**30:.3f} GiB", flush=True)
    check_launches(f"{tag} replays", counts(), served(n_req, backbone, ground))
    if int8:
        k5_request_profile(tag, lambda: engine.predict(image, PROMPTS[0]), cfg.vit_depth)

    # raw outputs of the last request: finite and of the right shape
    scores, presence, boxes, masks = first[-1][0]
    b, q, m = len(PROMPTS[-1]), cfg.num_queries, cfg.feat_size * 4
    for name, t, shape in (("scores", scores, (b, q)), ("presence", presence, (b,)),
                           ("boxes", boxes, (b, q, 4)), ("masks", masks, (b, q, m, m))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want {shape}) or non-finite")
    del engine, first
    torch.cuda.empty_cache()
    gemm_int8.GEMM_LORA_FUSED = False
    return launches, latencies, peak


class SyntheticSamples:
    """Seeded random samples as ``COCOSegmentDataset.load`` gives them: a
    uint8 image at the model's input size, 1-6 boxes (at most
    ``max_targets``) with box-shaped masks at the mask-loss resolution, and
    the sample's index as its COCO image id."""

    def __init__(self, cfg: ModelConfig, n: int, seed: int):
        self.cfg, self.n, self.seed = cfg, n, seed

    def __len__(self) -> int:
        return self.n

    def load(self, i: int, epoch: int = 0) -> Sample:
        rng = np.random.RandomState(self.seed * 1000 + i)
        r, t, m = self.cfg.img_size, self.cfg.max_targets, self.cfg.mask_loss_resolution
        boxes = np.zeros((t, 4), np.float32)
        valid = np.zeros((t,), bool)
        masks = np.zeros((t, m, m), bool)
        for j in range(min(rng.randint(1, 7), t)):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            w, h = rng.uniform(0.05, 0.3, 2)
            boxes[j], valid[j] = (cx, cy, w, h), True
            x0, x1 = int((cx - w / 2) * m), int(np.ceil((cx + w / 2) * m))
            y0, y1 = int((cy - h / 2) * m), int(np.ceil((cy + h / 2) * m))
            masks[j, y0:y1, x0:x1] = True
        return Sample(image=rng.randint(0, 256, (3, r, r), dtype=np.uint8), text="crack",
                      boxes=boxes, valid=valid, masks=masks, mask_valid=valid.copy(),
                      is_exhaustive=True, coco_image_id=i)


def fit(tag: str, g: torch.Generator, cfg: ModelConfig, lora: LoRAConfig, batch: int, steps: int,
        profile: bool = False):
    """Trainer.fit over ``steps`` batches of ``batch`` SyntheticSamples at
    ``cfg``, adapters drawn live. Returns (launches, losses, step times,
    peak bytes, profile): with ``profile``, ``measure.profile_step`` of one
    more step after the counts are read, else None."""
    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = TrainConfig(batch_size=batch, num_epochs=1, warmup_steps=0, logging_steps=1,
                           num_workers=2, seed=SEED, output_dir=out_dir)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, lora, tcfg, device="cuda")
        loader = DataLoader(SyntheticSamples(cfg, batch * steps, SEED), batch,
                            shuffle=False, num_workers=2)
        stats = trainer.setup(steps_per_epoch=len(loader))
        live_adapters(trainer.model, g)
        torch.cuda.synchronize()
        print(f"{tag}: built {stats['total_parameters']} params "
              f"({stats['trainable_parameters']} trainable) in {time.perf_counter() - t0:.2f} s",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        result = trainer.fit(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(out_dir, "train_stats.json")) as f:
            records = [json.loads(line) for line in f]
        prof = None
        if profile:
            first = batch_to_device(next(iter(loader.epoch(0))), "cuda")
            prof = profile_step(lambda: trainer.train_step(first))
    losses = [r["loss"] for r in records]
    times = [r["step_time_s"] for r in records]
    print(f"{tag}: {result['steps']} steps of batch {batch} in {wall:.2f} s; losses "
          f"{[round(x, 4) for x in losses]}; step time (s) {times} (first is the warm-up); "
          f"peak {peak / 2**30:.3f} GiB; launches { {k: v for k, v in launches.items() if v} }",
          flush=True)
    if result["steps"] != steps or len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: {result['steps']} steps, losses {losses}")
    del trainer
    torch.cuda.empty_cache()
    return launches, losses, times, peak, prof


def check_launches(tag: str, launches: dict, want: dict) -> None:
    """The launches equal ``want`` (its forwards' rotation passes added)
    and nothing else ran."""
    full = dict.fromkeys(launches, 0)
    full.update(with_rope(want))
    if launches != full:
        raise AssertionError(f"{tag} launches {launches}, expected {full}")


def phase_train(g: torch.Generator, int8: bool = False):
    """Trainer.fit over TRAIN_STEPS batches of TRAIN_BATCH at the full config;
    with ``int8`` the base is in the int8 tier and GEMM_BWD_KERNEL is on.
    Returns (launches, step times, peak bytes)."""
    tag = "train-int8" if int8 else "train"
    gemm_int8.GEMM_BWD_KERNEL = int8
    cfg = model_config(int8)
    launches, _, times, peak, _ = fit(tag, g, cfg, LORA, TRAIN_BATCH, TRAIN_STEPS)
    want = {k: v * TRAIN_STEPS for k, v in train_step_launches(cfg).items()}
    if int8:
        # K6: the dx of every block's GEMMs that pass the width gate (fc1,
        # fc2), once per step (the text encoder has no adapters, so no
        # gradient flows through it)
        d, hid = cfg.vit_dim, cfg.vit_mlp_hidden
        vit_kn = ((d, 3 * d), (d, d), (d, hid), (hid, d))
        m = TRAIN_BATCH * cfg.feat_size ** 2
        want["bf16_gemm_wres_nt"] = cfg.vit_depth * TRAIN_STEPS * sum(
            gemm_int8.supported_nt(m, k, n) for k, n in vit_kn)
    check_launches(tag, launches, want)
    gemm_int8.GEMM_BWD_KERNEL = False
    return launches, times, peak


def train_step_launches(cfg: ModelConfig) -> dict:
    """Attention and K4 launches of one training step at the ``windows_only``
    ViT policy and ``enc_remat`` (the defaults; LORA's adapters, qkv among
    them): the windowed ViT blocks run under remat, forward, replay in the
    backward, then one backward each; global blocks once; the fusion-encoder
    layers run under remat too, but keep their attention output (no replay).
    In the int8 tier, K4 for the 4 GEMMs of every ViT block and the text
    encoder's 3 per layer, and again in the windowed blocks' replays: qkv,
    proj and fc1. The replay stops before fc2's frozen product, as XLA drops
    it: ``LoRALinear.forward`` computes it last and the drop-path mask after
    it is held past the region (``models/layers.py::dropout``)."""
    n_global = len(cfg.vit_global_blocks)
    n_win = cfg.vit_depth - n_global
    want = {"window_attention_rope_packed": 2 * n_win, "long_attention_rope_packed": n_global,
            "long_attention_packed": cfg.enc_layers,
            "window_attention_rope_packed_bwd": n_win,
            "long_attention_rope_packed_bwd": n_global,
            "long_attention_packed_bwd": cfg.enc_layers}
    if cfg.base_quant != "none":
        want["int8_gemm_wres"] = 4 * cfg.vit_depth + 3 * n_win + 3 * cfg.text_layers
    return want


def bench_step_launches(cfg: ModelConfig) -> dict:
    """Kernel launches of one training step at bench.py's settings
    (``wo_block_mid``, ``enc_remat_ffn``, no ``dec_remat``, the
    ``bench_lora_config`` adapters, routing flags at their defaults, a
    windowed first block):
    * every attention layer's forward once: the windowed blocks keep their
      attention output across their replay, the global blocks and the
      encoder's attention run unrematted;
    * every backward once, but for the first block's: the bench set adapts
      fc1/fc2, not qkv, so no gradient is asked of anything before it;
    * K4 for the 4 GEMMs of every ViT block and the text encoder's 3 per
      layer, and again in the windowed blocks' replays: qkv (not the first
      block's attention region, which nothing asks to replay) and fc1. The
      MLP region's replay stops before fc2's frozen product, as XLA drops
      it: ``LoRALinear.forward`` computes it last and it saves nothing. No
      gradient crosses the text encoder, which has no adapter."""
    n_global = len(cfg.vit_global_blocks)
    n_win = cfg.vit_depth - n_global
    k1 = "window_attention_rope_packed" if cfg.vit_use_rope else "window_attention_packed"
    return {k1: n_win, k1 + "_bwd": n_win - 1,
            "long_attention_rope_packed": n_global, "long_attention_rope_packed_bwd": n_global,
            "long_attention_packed": cfg.enc_layers, "long_attention_packed_bwd": cfg.enc_layers,
            "int8_gemm_wres": 4 * cfg.vit_depth + 3 * cfg.text_layers + (n_win - 1) + n_win}


# K4's two kernels, by the name the profiler gives them
K4_KERNELS = ("S8Scaled", "quant_rows_kernel")
PROFILE_TOP = 15


def print_profile(tag: str, prof: dict) -> None:
    """The top kernels of one profiled step by device time, K4's total and
    share, and the device's busy share of the step's window."""
    k4 = [(ms, n) for name, (ms, n) in prof["kernels"].items() if any(s in name for s in K4_KERNELS)]
    k4_ms = sum(ms for ms, _ in k4)
    print(f"{tag} profile (one step, torch.profiler): device {prof['device_ms']:.3f} ms in a "
          f"{prof['window_ms']:.3f} ms window, busy share {prof['busy_share']:.4f}; K4 "
          f"{k4_ms:.3f} ms in {sum(n for _, n in k4)} launches, {k4_ms / prof['device_ms']:.4f} of "
          f"device time", flush=True)
    for name, (ms, n) in list(prof["kernels"].items())[:PROFILE_TOP]:
        print(f"{tag} profile {ms:10.3f} ms {n:6d}x  {name[:120]}", flush=True)


def phase_bench_train(g: torch.Generator):
    """Trainer.fit at bench.py's configuration and adapters, batch 8, one
    warm-up and three timed steps, then one profiled step."""
    cfg = bench_model_config()
    launches, losses, times, peak, prof = fit("bench-train", g, cfg, bench_lora_config(),
                                              BENCH_BATCH, TRAIN_STEPS, profile=True)
    per_step = bench_step_launches(cfg)
    check_launches("bench-train", launches, {k: v * TRAIN_STEPS for k, v in per_step.items()})
    print_profile("bench-train", prof)
    return launches, times, peak


ROUTES = (  # (tag, _PACKED, FUSE_ROPE, QKV_NATIVE, the windowed blocks' entry)
    ("default", True, True, False, window_attention_rope_packed),
    ("qkv-native", True, True, True, window_attention_rope_qkv),
    ("fuse-rope-off", True, False, False, wa.window_attention_pair_packed),
    ("packed-off", False, True, False, wa.window_attention_rope_grouped),
    ("packed-off-fuse-rope-off", False, False, False, wa.window_attention_grouped),
)
# the same flags with vit_use_rope=False: the packed chain is K1' whatever
# FUSE_ROPE says; W-p with RoPE is on no route (as in the JAX ViT, whose
# packed chain takes every case its wrapper would pack)
ROUTES_NO_ROPE = (
    ("default", True, True, False, wa.window_attention_packed),
    ("qkv-native", True, True, True, window_attention_qkv),
    ("packed-off", False, True, False, wa.window_attention_grouped),
)


def set_route(packed: bool, fuse_rope: bool, qkv_native: bool) -> None:
    wa._PACKED, wa.FUSE_ROPE, window_qkv.QKV_NATIVE = packed, fuse_rope, qkv_native


def phase_routes(g: torch.Generator):
    """One full-width bf16 model answers one request (raw outputs of
    ``_forward``, one image, one prompt) per window route; each route's
    counters show its entry and no other (a route is part of every graph's
    key: each request captures its two graphs), and its outputs agree with
    the default route's within SMALL_TOL. Then a ``vit_use_rope=False`` model
    answers one per route through K1', W-qkv and W-g without RoPE. Returns
    the forward launches by entry."""
    launches = {}

    def request(engine):
        img, _ = engine.preprocess(np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3))
                                   .astype(np.uint8))
        ids = engine.tokenizer(PROMPTS[0], context_length=engine.cfg.text_context_length)
        reset_counts()
        t0 = time.perf_counter()
        out = engine._forward(torch.from_numpy(img).cuda(),
                              torch.from_numpy(np.asarray(ids, np.int64)).cuda())
        torch.cuda.synchronize()
        return out, counts(), time.perf_counter() - t0, graph_delta()

    cfg = model_config(False)
    n_global = len(cfg.vit_global_blocks)
    n_win = cfg.vit_depth - n_global
    engine = SAM3LoRAInference(cfg, LORA, seed=SEED, device="cuda")
    live_adapters(engine.model, g)
    base = None
    for tag, packed, fuse_rope, qkv_native, entry in ROUTES:
        set_route(packed, fuse_rope, qkv_native)
        out, got, secs, delta = request(engine)
        # a route is part of every graph's key: each request captures both units
        check_launches(f"routes {tag}", got, served(
            1, {entry.__name__: n_win, "long_attention_rope_packed": n_global},
            {"long_attention_packed": cfg.enc_layers}, delta))
        launches[entry.__name__] = launches.get(entry.__name__, 0) + got[entry.__name__]
        if base is None:
            base = out
        errs = [(a - b).abs().max().item() for a, b in zip(out, base)]
        print(f"routes {tag}: {entry.__name__} x {got[entry.__name__]}, {secs:.3f} s, max abs "
              f"diff from the default route (scores, presence, boxes, masks) "
              f"{[f'{e:.3e}' for e in errs]} (bound {SMALL_TOL})", flush=True)
        if not max(errs) <= SMALL_TOL or not all(torch.isfinite(t).all() for t in out):
            raise AssertionError(f"routes {tag}: outputs differ from the default route by {errs}")
    set_route(True, True, False)
    del engine, base
    torch.cuda.empty_cache()

    engine = SAM3LoRAInference(cfg.replace(vit_use_rope=False), LORA, seed=SEED, device="cuda")
    live_adapters(engine.model, g)
    base = None
    for tag, packed, fuse_rope, qkv_native, entry in ROUTES_NO_ROPE:
        set_route(packed, fuse_rope, qkv_native)
        out, got, secs, delta = request(engine)
        # without RoPE the global blocks take the K3 entry, long_attention_packed
        check_launches(f"routes no-rope {tag}", got, served(
            1, {entry.__name__: n_win, "long_attention_packed": n_global},
            {"long_attention_packed": cfg.enc_layers}, delta))
        launches[entry.__name__] = launches.get(entry.__name__, 0) + got[entry.__name__]
        base = out if base is None else base
        errs = [(a - b).abs().max().item() for a, b in zip(out, base)]
        print(f"routes vit_use_rope=False {tag}: {entry.__name__} x {got[entry.__name__]}, "
              f"{secs:.3f} s, max abs diff from its default route {[f'{e:.3e}' for e in errs]}",
              flush=True)
        if not max(errs) <= SMALL_TOL or not all(torch.isfinite(t).all() for t in out):
            raise AssertionError(f"routes no-rope {tag}: outputs differ by {errs}")
    set_route(True, True, False)
    del engine
    torch.cuda.empty_cache()

    # W-p with RoPE is on no ViT route (the packed chain takes every case the
    # wrapper would pack, as in the JAX ViT): its entry is
    # dot_product_attention(impl="window") with the tables, forward and back
    # at one image's windows
    dh, ws = cfg.vit_dim // cfg.vit_heads, cfg.vit_window_size
    shape = ((cfg.feat_size // ws) ** 2, cfg.vit_heads, ws * ws, dh)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    cos, sin = rope_tables(dh, ws, 1.0)
    reset_counts()
    out = dot_product_attention(q, k, v, scale=dh ** -0.5, impl="window", rope_cos=cos,
                                rope_sin=sin)
    out.backward(torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16))
    torch.cuda.synchronize()
    got = counts()
    entry = wa.window_attention_rope_pair_packed.__name__
    check_launches("routes dot_product_attention(impl='window', rope)", got,
                   {entry: 1, entry + "_bwd": 1})
    if not all(torch.isfinite(t).all() for t in (out, q.grad, k.grad, v.grad)):
        raise AssertionError("dot_product_attention(impl='window', rope): non-finite output")
    print(f"routes dot_product_attention(impl='window', rope) q{shape}: {entry} x 1, "
          f"backward x 1, finite", flush=True)
    launches[entry] = got[entry]
    launches[entry + "_bwd"] = got[entry + "_bwd"]
    return launches


# the processor's box prompt (normalized cxcywh), on the last of its prompts
PROC_BOX = np.array([[0.5, 0.5, 0.4, 0.3]], np.float32)
PROC_REPS = 3


def fmt_s(times) -> str:
    return "[" + ", ".join(f"{t:.4f}" for t in times) + "]"


def set_image_launches(cfg: ModelConfig) -> dict:
    """Launches of one ``Sam3Processor.set_image``: the ViT's attention (K1
    in every windowed block, K2 in the global ones) and, in the int8 tier
    with ``GEMM_LORA_FUSED``, K5 for every block's adapted qkv, fc1 and fc2
    (LORA's ViT targets) and K4 for its proj."""
    n_global = len(cfg.vit_global_blocks)
    want = {"window_attention_rope_packed": cfg.vit_depth - n_global,
            "long_attention_rope_packed": n_global}
    if cfg.base_quant != "none":
        want["int8_lora_gemm_wres"] = 3 * cfg.vit_depth
        want["int8_gemm_wres"] = cfg.vit_depth
    return want


def prompt_launches(cfg: ModelConfig) -> dict:
    """Launches of one ``set_text_prompt``: K3 in every fusion-encoder
    layer and, in the int8 tier, K4 for the text encoder's out_proj, c_fc
    and c_proj in every layer; no ViT kernel."""
    want = {"long_attention_packed": cfg.enc_layers}
    if cfg.base_quant != "none":
        want["int8_gemm_wres"] = 3 * cfg.text_layers
    return want


def host_seconds(fn):
    """(fn(), host seconds to a device sync)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_processor(g: torch.Generator, int8: bool = False):
    """Sam3Processor at the full config, PROC_REPS times: one set_image,
    then PROMPTS[-1] one prompt at a time (the last with PROC_BOX), launch
    counts equal to the design's for each graph captured and none for a
    replay; the median times of set_image, each prompt, and ``predict`` of
    the same prompts one at a time and together; one profiled set_image and
    prompt, their device kernels the eager ones'; the cached features and a
    text and a box prompt's raw outputs bit for bit the model's own eager
    forward on the same preprocessed image."""
    tag = "processor-int8" if int8 else "processor"
    gemm_int8.GEMM_LORA_FUSED = int8
    proc = Sam3Processor(model_config(int8), LORA, seed=SEED, device="cuda")
    cfg, engine = proc.cfg, proc.engine
    live_adapters(proc.model, g)
    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    prompts = PROMPTS[-1]
    boxes = [None] * (len(prompts) - 1) + [PROC_BOX]
    proc.set_image(image).set_text_prompt("warm-up", boxes=PROC_BOX)  # first calls: set-up
    engine.predict(image, ["warm-up"])
    torch.cuda.synchronize()

    t_set, t_prompts = [], [[] for _ in prompts]
    m = cfg.feat_size * 4
    for _ in range(PROC_REPS):
        reset_counts()
        t_set.append(host_seconds(lambda: proc.set_image(image))[1])
        check_launches(f"{tag} set_image", counts(), served(1, set_image_launches(cfg)))
        for j, (prompt, box) in enumerate(zip(prompts, boxes)):
            reset_counts()
            res, secs = host_seconds(lambda: proc.set_text_prompt(prompt, boxes=box))
            check_launches(f"{tag} set_text_prompt({prompt!r})", counts(),
                           served(1, ground=prompt_launches(cfg)))
            t_prompts[j].append(secs)
            n = res["num_detections"]
            if (res["boxes"].shape != (n, 4) or res["masks_lowres"].shape != (n, m, m)
                    or not np.isfinite(res["boxes"]).all() or not np.isfinite(res["scores"]).all()
                    or not 0.0 <= res["presence"] <= 1.0):
                raise AssertionError(f"{tag}: bad result for {prompt!r}: {n} detections, "
                                     f"presence {res['presence']}")
    t_single = [[host_seconds(lambda: engine.predict(image, [p]))[1] for _ in range(PROC_REPS)]
                for p in prompts]
    t_batch = [host_seconds(lambda: engine.predict(image, prompts))[1] for _ in range(PROC_REPS)]
    med = statistics.median
    set_s, prompt_s, single_s = med(t_set), [med(t) for t in t_prompts], [med(t) for t in t_single]
    print(f"{tag}: host s, median of {PROC_REPS}: set_image {set_s:.4f} {fmt_s(t_set)}; "
          f"set_text_prompt {[round(t, 4) for t in prompt_s]} for {list(prompts)} (box prompt on "
          f"the last) {' '.join(fmt_s(t) for t in t_prompts)}; predict one prompt at a time "
          f"{[round(t, 4) for t in single_s]} {' '.join(fmt_s(t) for t in t_single)}, all "
          f"{len(prompts)} in one request {med(t_batch):.4f} {fmt_s(t_batch)}; set_image + "
          f"{len(prompts)} prompts {set_s + sum(prompt_s):.4f} against {len(prompts)} requests "
          f"{sum(single_s):.4f}", flush=True)
    for name, fn in (("set_image", lambda: proc.set_image(image)),
                     (f"set_text_prompt({prompts[0]!r})", lambda: proc.set_text_prompt(prompts[0]))):
        prof = profile_step(fn)
        print(f"{tag} profile (one {name}, torch.profiler): {prof['device_ms']:.3f} device ms in "
              f"a {prof['window_ms']:.3f} ms window, busy share {prof['busy_share']:.4f}",
              flush=True)

    # the processor's cached features and raw outputs, a text prompt and a
    # box prompt, bit for bit the model's own eager forward's on the same
    # preprocessed image; each unit's replayed kernels the eager ones (the
    # device trace)
    x = torch.from_numpy(engine.preprocess(image)[0]).cuda()
    model = proc.model
    with torch.inference_mode():
        diffs = {"set_image": as_eager(f"{tag} set_image",
                                       [*proc._state["feats"], *proc._state["poss"]],
                                       lambda: [t for ts in model.backbone_image(x) for t in ts])}
        for prompt, box in ((prompts[0], None), (prompts[-1], PROC_BOX)):
            geo, ids = proc.geo_prompt(box), proc._tokens(prompt)
            diffs[prompt] = as_eager(f"{tag} {prompt!r}", proc.ground(prompt, geo),
                                     lambda: eager_outputs(engine, x, ids, geo))
        feats, poss = model.backbone_image(x)
        batch = Batch(images=None, token_ids=proc._tokens(prompts[0]),
                      img_ids=torch.zeros((1,), dtype=torch.long, device="cuda"),
                      geo=proc.geo_prompt())
        own = [same_kernels(f"{tag} backbone", lambda: engine.backbone_image(x),
                            lambda: model.backbone_image(x)),
               same_kernels(f"{tag} grounding", lambda: engine.ground(feats, poss, batch),
                            lambda: head_outputs(model.ground(feats, poss, batch)))]
    del feats, poss
    print(f"{tag}: the replays bit for bit the eager forward: max |replay - eager| {diffs}; "
          f"the port's kernels of the backbone and a grounding the eager ones' ({own}, the "
          f"device trace)", flush=True)
    del proc, engine
    torch.cuda.empty_cache()
    gemm_int8.GEMM_LORA_FUSED = False


VALIDATE_IMAGES = 8
NMS_IOU = 0.7
NMS_REPS = 20


def nms_device_loop(iou, scores, iou_threshold: float, valid=None):
    """The design ``ops/nms.py`` was measured against: its greedy recurrence
    kept on the card, as JAX's ``fori_loop`` keeps it, three launches a row
    (an AND, a NOT, an in-place AND). The same keep mask as
    ``generic_nms_mask``."""
    order, sup, keep = nms_ops.greedy_order(iou, scores, iou_threshold, valid)
    keep = keep.clone()
    for i in range(len(keep)):
        keep &= ~(sup[i] & keep[i])
    out = torch.zeros_like(keep)
    out[order] = keep
    return out


def check_nms(engine, sample) -> dict:
    """One image's 200 candidates: the keep mask on the card (``nms_masks``,
    and the device loop it was measured against) and mask_iou against the
    CPU's, bit for bit; the median times of mask_iou and of each loop."""
    cfg = engine.cfg
    ids = engine.tokenizer([sample.text], context_length=cfg.text_context_length)
    scores, _, _, masks = engine._forward(
        torch.from_numpy(sample.image[None]).cuda(),
        torch.from_numpy(np.asarray(ids, np.int64)).cuda())
    s, m = scores[0], masks[0] > 0.5
    iou = mask_iou(m, m)
    if not torch.equal(iou.cpu(), mask_iou(m.cpu(), m.cpu())):
        raise AssertionError("mask_iou on the card differs from the CPU's")
    want = nms_ops.nms_masks(m.cpu(), s.cpu(), NMS_IOU)
    for name, got in (("nms_masks", nms_ops.nms_masks(m, s, NMS_IOU)),
                      ("the device loop", nms_device_loop(iou, s, NMS_IOU))):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"NMS ({name}) on the card differs from the CPU's: "
                                 f"{int((got.cpu() != want).sum())} of {len(want)} rows")
    # CUDA-event ms, host time included (the host loop blocks the host
    # between the two events)
    return {"n": len(s), "kept": int(want.sum()),
            "mask_iou_ms": median_ms(lambda: mask_iou(m, m), NMS_REPS),
            "host_loop_ms": median_ms(lambda: nms_ops.generic_nms_mask(iou, s, NMS_IOU), NMS_REPS),
            "device_loop_ms": median_ms(lambda: nms_device_loop(iou, s, NMS_IOU), NMS_REPS)}


def phase_validate(g: torch.Generator):
    """cli.validate's per-image work, dump and metrics over VALIDATE_IMAGES
    seeded samples at the full bf16 config; the NMS of one image on the
    card against the CPU; the time split and images/s."""
    cfg = model_config(False)
    engine = SAM3LoRAInference(cfg, LORA, seed=SEED, device="cuda")
    live_adapters(engine.model, g)
    ds = SyntheticSamples(cfg, VALIDATE_IMAGES, SEED)
    nms = check_nms(engine, ds.load(0))  # also the warm-up
    print(f"validate nms: {nms['n']} candidates, {nms['kept']} kept at IoU {NMS_IOU}, the card's "
          f"keep (ops.nms, the host loop; and the device loop) and mask_iou bit for bit the "
          f"CPU's; median ms of {NMS_REPS}: mask_iou {nms['mask_iou_ms']:.4f}, host loop "
          f"{nms['host_loop_ms']:.4f}, device loop {nms['device_loop_ms']:.4f}", flush=True)

    reset_counts()
    (gts, dts, secs), wall = host_seconds(lambda: validate_images(engine, ds))
    n_global = len(cfg.vit_global_blocks)
    check_launches("validate", counts(), served(
        VALIDATE_IMAGES, {"window_attention_rope_packed": cfg.vit_depth - n_global,
                          "long_attention_rope_packed": n_global},
        {"long_attention_packed": cfg.enc_layers}))
    kept = [len(dts[i]) for i in range(VALIDATE_IMAGES)]
    with tempfile.TemporaryDirectory() as out_dir:
        path, t_dump = host_seconds(lambda: dump_predictions(dts, out_dir))
        records = load_predictions(path)
        # the same dump through the numpy encoder: its strings byte for byte
        # the codec's
        codec_encode = eval_writer.rle_encode
        eval_writer.rle_encode = rle_encode_numpy
        try:
            path_np, t_dump_np = host_seconds(lambda: dump_predictions(dts, out_dir + "/np"))
        finally:
            eval_writer.rle_encode = codec_encode
        strings = [r["segmentation"]["counts"] for r in records]
        if strings != [r["segmentation"]["counts"] for r in load_predictions(path_np)]:
            raise AssertionError("validate: the native codec's RLE strings differ from the numpy "
                                 "encoder's")
    # the dump decodes back to the kept masks, bit for bit
    for i in range(VALIDATE_IMAGES):
        want = sorted((d["score"], d["mask"].astype(np.uint8).tobytes()) for d in dts[i])
        got = sorted((r["score"], rle_decode(r["segmentation"]).tobytes())
                     for r in records if r["image_id"] == i)
        if got != want:
            raise AssertionError(f"validate: the dump of image {i} does not decode to its "
                                 f"{len(want)} kept masks ({len(got)} records)")
    results, t_metrics = host_seconds(lambda: score_predictions(gts, dts, VALIDATE_IMAGES, 0.3,
                                                         NMS_IOU, False))
    total = secs["forward"] + secs["nms"] + t_dump + t_metrics
    print(f"validate: {VALIDATE_IMAGES} images, kept {kept} masks (top 100 each), the dump's "
          f"{len(records)} RLE records decode to them bit for bit, its strings byte for byte the "
          f"numpy encoder's; seconds: forward {secs['forward']:.4f}, NMS and selection "
          f"{secs['nms']:.4f}, encode/dump {t_dump:.4f} (native codec; the numpy encoder's dump "
          f"{t_dump_np:.4f}), metrics {t_metrics:.4f}; validate_images {wall:.4f} s in all; "
          f"{VALIDATE_IMAGES / total:.4f} images/s over the four "
          f"({VALIDATE_IMAGES / (total - t_dump + t_dump_np):.4f} with the numpy dump), "
          f"{VALIDATE_IMAGES / (total - t_dump):.4f} without the dump; metrics "
          f"{ {k: round(results[k], 6) for k in ('mAP', 'mAP_50', 'mAP_75', 'cgF1')} }",
          flush=True)
    bad = {k: results[k] for k in ("mAP", "mAP_50", "mAP_75", "cgF1")
           if not (np.isfinite(results[k]) and 0.0 <= results[k] <= 1.0)}
    if bad or not sum(kept):
        raise AssertionError(f"validate: metrics {bad} out of [0, 1], or no mask kept ({kept})")
    del engine
    torch.cuda.empty_cache()


CLICK = dict(point_coords=[[600.0, 450.0]], point_labels=[1], multimask_output=True)
BOX_CLICK = dict(point_coords=[[300.0, 200.0]], point_labels=[0], box=[100.0, 100.0, 800.0, 600.0],
                 multimask_output=False)
GT_BOXES = np.array([[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.25, 0.2]], np.float32)  # cxcywh


def heads_against_cpu(pred: SAM3InteractiveImagePredictor, prompts) -> float:
    """The predictor's SAM heads on its device against the same heads in
    fp32 on the CPU, on the cached features moved to the host: every
    prompt's multimask logits and IoU. Returns the worst max |device - cpu| /
    max |cpu|."""
    cpu = tracker_core(pred.cfg.replace(dtype="float32"), torch.device("cpu"))
    cpu.load_state_dict({k: v.cpu() for k, v in pred.core.state_dict().items()})
    cpu.eval()
    feats = (pred._features, {k: v.float().cpu() for k, v in pred._features.items()})
    worst = 0.0
    for kw in prompts:
        coords, labels = pred._prep_prompts(kw.get("point_coords"), kw.get("point_labels"),
                                            kw.get("box"))
        outs = []
        for core, f in zip((pred.core, cpu), feats):
            dev = f["vis"].device
            with torch.inference_mode():
                masks, iou, _, _ = core.predict_masks(
                    core.no_memory_features(f["vis"]), [f["hi0"], f["hi1"]],
                    coords.to(dev), labels.to(dev), multimask_output=True)
            outs.append((masks.float().cpu(), iou.float().cpu()))
        for got, want in zip(*outs):
            worst = max(worst, (got - want).abs().max().item() / want.abs().max().item())
    return worst


def phase_interactive(g: torch.Generator):
    """SAM3InteractiveImagePredictor on a Sam3Processor at the full bf16
    config: set_image of the 1200x900 image (K1 and K2 only), a click with
    multimask output, a box and a negative click with single output,
    predict_batch over two images (no K1/K2 in any predict); the heads held
    against their fp32 CPU run; interactive_ground for 2 refinement steps
    (each stage K3 only); the median times (of PROC_REPS, after a warm-up)
    of set_image, a click and a stage; one profiled click."""
    tag = "interactive"
    proc = Sam3Processor(model_config(False), LORA, seed=SEED, device="cuda")
    cfg = proc.cfg
    live_adapters(proc.model, g)
    pred = SAM3InteractiveImagePredictor(proc, seed=SEED)
    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    image2 = np.random.RandomState(SEED + 1).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    pred.set_image(image).predict(**CLICK)  # first calls: set-up
    pred.predict(**BOX_CLICK)
    proc.set_text_prompt("warm-up", boxes=PROC_BOX)
    torch.cuda.synchronize()

    t_set, t_click = [], []
    low = cfg.feat_size * 4
    for _ in range(PROC_REPS):
        reset_counts()
        t_set.append(host_seconds(lambda: pred.set_image(image))[1])
        check_launches(f"{tag} set_image", counts(), served(1, set_image_launches(cfg)))
        for kw, n in ((CLICK, 3), (BOX_CLICK, 1)):
            reset_counts()
            (masks, iou, lowres), secs = host_seconds(lambda: pred.predict(**kw))
            check_launches(f"{tag} predict", counts(), served(0))
            if kw is CLICK:
                t_click.append(secs)
            if (masks.shape != (n, 900, 1200) or masks.dtype != bool or iou.shape != (n,)
                    or lowres.shape != (n, low, low) or not np.isfinite(lowres).all()
                    or not np.isfinite(iou).all()):
                raise AssertionError(f"{tag}: bad predict output {masks.shape} {masks.dtype} "
                                     f"{iou.shape} {lowres.shape}")
    worst = heads_against_cpu(pred, (CLICK, BOX_CLICK))
    print(f"{tag}: the card's heads (bf16) against their fp32 CPU run on the cached features: "
          f"max |card - cpu| / max |cpu| {worst:.5f} (limit {SMALL_TOL})", flush=True)
    if worst > SMALL_TOL:
        raise AssertionError(f"{tag}: heads differ from the CPU's by {worst}")
    reset_counts()
    outs = pred.predict_batch([image, image2], [[[600.0, 450.0]], [[200.0, 300.0]]], [[1], [1]])
    check_launches(f"{tag} predict_batch", counts(), served(2, set_image_launches(cfg)))
    if [o[0].shape for o in outs] != [(3, 900, 1200)] * 2:
        raise AssertionError(f"{tag}: predict_batch shapes {[o[0].shape for o in outs]}")
    prof = profile_step(lambda: pred.predict(**CLICK))

    # interactive_ground: every stage one set_text_prompt, counted and timed
    stages_seen = []
    plain_prompt = proc.set_text_prompt

    def counted(*a, **k):
        reset_counts()
        out, secs = host_seconds(lambda: plain_prompt(*a, **k))
        stages_seen.append((counts(), secs, graph_delta()))
        return out

    proc.set_text_prompt = counted
    try:
        stages = interactive_ground(proc, image, "crack", GT_BOXES, num_interactive_steps=2,
                                    threshold=0.0)
    finally:
        del proc.set_text_prompt
    for i, (st, (launches, _, delta)) in enumerate(zip(stages, stages_seen)):
        check_launches(f"{tag} stage {i}", launches,
                       served(1, ground=prompt_launches(cfg), delta=delta))
        if not (np.isfinite(st["scores"]).all() and np.isfinite(st["boxes"]).all()):
            raise AssertionError(f"{tag}: stage {i} outputs are not finite")
    if len(stages) < 2:  # the sampler stops early only when it finds no error
        raise AssertionError(f"{tag}: {len(stages)} stage, no refinement step ran")
    t_stage = [secs for _, secs, _ in stages_seen]
    med = statistics.median
    print(f"{tag}: host s, median of {PROC_REPS}: set_image {med(t_set):.4f} {fmt_s(t_set)}, "
          f"click (multimask) {med(t_click):.4f} {fmt_s(t_click)}, interactive_ground stage "
          f"{med(t_stage):.4f} {fmt_s(t_stage)} with {[len(st['prompt_boxes']) for st in stages]} "
          f"box prompts; profile (one click, torch.profiler): {prof['device_ms']:.3f} device ms "
          f"in a {prof['window_ms']:.3f} ms window, busy share {prof['busy_share']:.4f}",
          flush=True)
    del pred
    return proc  # the agent phase drives it next


AGENT_PHRASES = ("crack", "wall")  # the tool agent's two phrases
AGENT_CONCEPT = "the crack"        # agent_inference's concept: refined to "crack", "cracks", "object"
# the masks the second phrase keeps: at threshold 0 random weights keep all
# 200 queries, and the copy's viz would spend the phase on the host drawing
# 200 masks at 1200x900, each on its own and all as a set of marks
AGENT_MASKS = 5


def sync_of(device):
    """A function that waits for ``device``'s queued work."""
    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


class TimedLLM(ScriptedLLM):
    """A ScriptedLLM that notes the host clock at each call."""

    def __init__(self, turns):
        super().__init__(turns)
        self.times = []

    def __call__(self, messages):
        self.times.append(time.perf_counter())
        return super().__call__(messages)


def tool_turn(name: str, **params) -> str:
    return f"<tool>{json.dumps({'name': name, 'parameters': params})}</tool>"


def count_calls(proc, sync) -> list:
    """Wrap ``proc.set_image`` and ``proc.set_text_prompt`` (instance
    attributes; ``del`` them to unwrap): each call appends (method, its
    first argument for a prompt, its launches, host s to a sync, its
    detections for a prompt, its graph_delta)."""
    calls = []

    def wrap(name):
        plain = getattr(proc, name)

        def counted(*a, **k):
            reset_counts()
            t0 = time.perf_counter()
            out = plain(*a, **k)
            sync()
            calls.append((name, a[0] if name == "set_text_prompt" else None, counts(),
                          time.perf_counter() - t0,
                          out["num_detections"] if name == "set_text_prompt" else None,
                          graph_delta()))
            return out

        setattr(proc, name, counted)

    wrap("set_image")
    wrap("set_text_prompt")
    return calls


def agent_drive(proc, image: np.ndarray, device) -> dict:
    """tool_agent_inference over ``proc`` with a scripted LLM, at the
    threshold under the second phrase's AGENT_MASKS best scores:
    segment_phrase, the same phrase again (rejected), a second phrase,
    examine_each_mask (Accept the even masks, Reject the odd ones), then
    select_masks_and_return of masks 2, 1 and 2 again and one past the end
    (the first two survivors, masks 0 and 2 of the phrase). Then
    agent.agent_inference with RuleBasedRefiner at threshold 1 (no
    detection, so it refines for its 4 rounds). Returns each call's launches
    and host s, the results and the processor's own output on the phrase."""
    sync = sync_of(device)
    h, w = image.shape[:2]
    scores = proc.set_image(image).set_text_prompt(AGENT_PHRASES[1], threshold=-1.0)["scores"]
    thr = float(np.sort(scores)[::-1][AGENT_MASKS])
    want = proc.set_text_prompt(AGENT_PHRASES[1], threshold=thr)
    n = want["num_detections"]
    if n < 3:
        raise AssertionError(f"agent: {n} masks at threshold {thr}, the script needs 3")
    turns = [tool_turn("segment_phrase", text_prompt=AGENT_PHRASES[0]),
             tool_turn("segment_phrase", text_prompt=AGENT_PHRASES[0]),
             tool_turn("segment_phrase", text_prompt=AGENT_PHRASES[1]),
             tool_turn("examine_each_mask")]
    turns += [f"<verdict>{'Reject' if i % 2 else 'Accept'}</verdict>" for i in range(n)]
    turns.append(tool_turn("select_masks_and_return", final_answer_masks=[2, 1, 2, n + 5]))
    llm = TimedLLM(turns)
    calls = count_calls(proc, sync)
    try:
        t0 = time.perf_counter()
        res = tool_agent_inference(proc, image, "the cracks in the wall", llm,
                                   max_generations=len(turns), threshold=thr)
        t_end = time.perf_counter()
        tool_calls = len(calls)
        refined = agent_inference(proc, image, AGENT_CONCEPT, RuleBasedRefiner(), threshold=1.0)
    finally:
        del proc.set_image, proc.set_text_prompt
    t = llm.times
    examine_end = 4 + n  # the select call's index among the LLM calls
    seconds = {"set_image": t[0] - t0, "segment_phrase": t[1] - t[0], "duplicate": t[2] - t[1],
               "segment_phrase 2": t[3] - t[2], f"examine_each_mask ({n} masks)": t[examine_end] - t[3],
               "select_masks_and_return": t_end - t[examine_end]}
    picked = [0, 2]
    return {"result": res, "calls": calls[:tool_calls], "refine_calls": calls[tool_calls:],
            "refined": refined, "seconds": seconds, "n": n, "picked": picked, "threshold": thr,
            "masks": _upsample_masks(want["masks_lowres"][picked], h, w),
            "boxes": [list(map(float, b)) for b in want["boxes"][picked]],
            "scores": [float(s) for s in want["scores"][picked]]}


def check_agent(tag: str, cfg: ModelConfig, image: np.ndarray, got: dict) -> None:
    """set_image once with the ViT's kernels (each run), each segment_phrase
    K3 alone; the duplicate phrase rejected (no grounding, and named as
    tried in the pruned history); the selected masks at the
    image's size, those the processor's own output gives at the picked
    indices, with their boxes and scores; agent_inference's 4 rounds."""
    res, calls = got["result"], got["calls"]
    names = [c[:2] for c in calls]
    want_names = [("set_image", None)] + [("set_text_prompt", p) for p in AGENT_PHRASES]
    if names != want_names:
        raise AssertionError(f"{tag}: processor calls {names}, expected {want_names}")
    for name, prompt, launches, _, _, delta in calls + got["refine_calls"]:
        check_launches(f"{tag} {name}({prompt!r})", launches,
                       served(1, set_image_launches(cfg), delta=delta) if name == "set_image"
                       else served(1, ground=prompt_launches(cfg), delta=delta))
    # the duplicate grounded nothing (the calls above), and the pruned
    # history's preamble lists the first phrase as tried
    rejected = f"do NOT reuse): ['{AGENT_PHRASES[0]}']" in res.transcript[1]["content"]
    same = (len(res.masks) == len(got["masks"])
            and all(a.shape == image.shape[:2] and a.dtype == bool and np.array_equal(a, b)
                    for a, b in zip(res.masks, got["masks"]))
            and res.boxes == got["boxes"] and res.scores == got["scores"])
    if res.no_mask or res.used_prompts != list(AGENT_PHRASES) or not rejected or not same:
        raise AssertionError(f"{tag}: no_mask {res.no_mask}, prompts {res.used_prompts}, "
                             f"duplicate rejected {rejected}, selection equal to the "
                             f"processor's masks {got['picked']}: {same}")
    refined = got["refined"]
    phrases = [c[1] for c in got["refine_calls"] if c[0] == "set_text_prompt"]
    # the 4 rounds ground these phrases; the last reply refines once more
    if (refined.rounds != 4 or refined.phrase != "objects"
            or phrases != ["the crack", "crack", "cracks", "object"]):
        raise AssertionError(f"{tag}: agent_inference rounds {refined.rounds}, phrases {phrases}")


def phase_agent(proc: Sam3Processor, smi: str) -> None:
    """The agent tier on the interactive phase's bf16 processor (full
    config, live adapters) over the 1200x900 image: agent_drive's scripted
    tool agent and the rule-based refiner, checked by check_agent; host s
    per tool call."""
    tag = "agent"
    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    got = agent_drive(proc, image, "cuda")
    check_agent(tag, proc.cfg, image, got)
    refine_s = [c[3] for c in got["refine_calls"]]
    print(f"{tag}: tool_agent_inference at threshold {got['threshold']:.6f} ("
          f"{[c[4] for c in got['calls'][1:]]} masks of {list(AGENT_PHRASES)}), masks "
          f"{got['picked']} of {AGENT_PHRASES[1]!r} selected; host s per tool call "
          + ", ".join(f"{k} {v:.4f}" for k, v in got["seconds"].items())
          + f"; processor calls (host s) {[round(c[3], 4) for c in got['calls']]}; "
          f"agent_inference (RuleBasedRefiner, {got['refined'].rounds} rounds) set_image and "
          f"prompts (host s) {[round(s, 4) for s in refine_s]} | {smi}", flush=True)


def decoder_options(cfg: ModelConfig, device, g: torch.Generator):
    """The decoder's dense boxRPB oracle (``dec_separable_bias=False``)
    against its separable route on one set of weights and inputs, and a
    ``box_rpb="none"`` decoder on the same inputs. Returns (max |dense -
    separable| / max |separable| over the layers' queries, boxes and
    presence logits; whether the no-RPB outputs are finite)."""
    decs = {}
    for name, over in (("separable", {}), ("dense", dict(dec_separable_bias=False)),
                       ("none", dict(box_rpb="none"))):
        decs[name] = TransformerDecoder(Spec(model=cfg.replace(**over), device=device)).eval()
        init_model(decs[name], g)
    decs["dense"].load_state_dict(decs["separable"].state_dict())
    hw, d = cfg.feat_size, cfg.d_model
    mem, pos = (torch.randn(1, hw * hw, d, generator=g, device=device) for _ in range(2))
    text = torch.randn(1, cfg.text_context_length, d, generator=g, device=device)
    tmask = torch.arange(cfg.text_context_length, device=device)[None] >= 5
    with torch.inference_mode():
        outs = {k: m(mem, pos, text, tmask, (hw, hw)) for k, m in decs.items()}
    worst = 0.0
    for field in ("hs", "pred_coords", "presence_logits"):
        a, b = getattr(outs["dense"], field).float(), getattr(outs["separable"], field).float()
        worst = max(worst, (a - b).abs().max().item() / b.abs().max().item())
    finite = all(torch.isfinite(getattr(outs["none"], f)).all().item()
                 for f in ("hs", "pred_coords", "presence_logits"))
    return worst, finite


def phase_model_options(g: torch.Generator):
    """The model options at the full bf16 config: a mask prompt (1200x900)
    through a geo_mask_prompts model (K3 only, finite, 72^2 more prompt
    tokens); the dense boxRPB oracle within SMALL_TOL of the separable
    route; a box_rpb="none" decoder finite."""
    tag = "model options"
    cfg = ModelConfig(dtype="bfloat16", geo_mask_prompts=True)
    proc = Sam3Processor(cfg, LORA, seed=SEED, device="cuda")
    live_adapters(proc.model, g)
    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    mask = np.zeros((900, 1200), np.float32)
    mask[200:700, 300:900] = 1.0
    proc.set_image(image).set_text_prompt("warm-up", mask_prompt=mask)
    reset_counts()
    res, secs = host_seconds(lambda: proc.set_text_prompt("crack", mask_prompt=mask))
    check_launches(f"{tag} mask prompt", counts(), served(1, ground=prompt_launches(cfg)))
    if not (np.isfinite(res["scores"]).all() and np.isfinite(res["boxes"]).all()
            and 0.0 <= res["presence"] <= 1.0):
        raise AssertionError(f"{tag}: the mask prompt's outputs are not finite")
    geo = proc.geo_prompt()
    feats = proc._state["feats"][-1]
    tokens = feats.flatten(2).transpose(1, 2)
    lengths = []
    for m in (None, mask):
        if m is not None:
            geo.mask_embeddings = torch.from_numpy(m)[None, None].cuda()
            geo.mask_mask = torch.zeros((1, 1), dtype=torch.bool, device="cuda")
            geo.mask_labels = torch.ones((1, 1), dtype=torch.long, device="cuda")
        with torch.inference_mode():
            seq, _ = proc.model.geometry_encoder(geo, tokens, tokens, feats.shape[-2:])
        lengths.append(seq.shape[1])
    if lengths[1] - lengths[0] != cfg.feat_size ** 2:
        raise AssertionError(f"{tag}: the mask prompt adds {lengths[1] - lengths[0]} prompt tokens")
    del proc
    torch.cuda.empty_cache()
    worst, finite = decoder_options(model_config(False), "cuda", g)
    print(f"{tag}: a 1200x900 mask prompt in {secs:.4f} s, finite, K3 x{cfg.enc_layers}, geometry "
          f"tokens {lengths[0]} -> {lengths[1]}; the dense boxRPB oracle against the separable "
          f"route max |dense - separable| / max |separable| {worst:.5f} (limit {SMALL_TOL}); "
          f"box_rpb='none' outputs finite {finite}", flush=True)
    if worst > SMALL_TOL or not finite:
        raise AssertionError(f"{tag}: dense oracle off by {worst}, or box_rpb='none' not finite")
    torch.cuda.empty_cache()


# the video phase: VIDEO_FRAMES frames at 1200x900, so that the ring of
# num_maskmem - 1 recent frames evicts (7 - 1 = 6 ring slots fill by the
# seventh frame after a spawn)
VIDEO_FRAMES = 12
VIDEO_SLOTS, VIDEO_MASKMEM, VIDEO_PTRS = 16, 7, 16
VIDEO_CPU_SLOTS = 2  # live slots held against the fp32 CPU run (each slot is independent)


def video_frames(n: int, seed: int = SEED, shape=(900, 1200, 3)):
    return [np.random.RandomState(seed + i).randint(0, 256, shape).astype(np.uint8)
            for i in range(n)]


def check_track_state(tag: str, st: TrackState, num_maskmem: int, max_obj_ptrs: int) -> None:
    """Live ids unique and >= 0, free slots -1; every live slot's cond
    memory written; its ring ages distinct and within the window (under
    num_maskmem - 1: an evicted frame's slot is rewritten); its pointer
    ages distinct and under max_obj_ptrs; finite mask logits."""
    alive = st.alive.cpu().numpy()
    ids = st.obj_ids.cpu().numpy()
    age, page = st.maskmem_age.cpu().numpy(), st.obj_ptr_age.cpu().numpy()
    live = ids[alive]
    if (live < 0).any() or len(set(live.tolist())) != len(live) or (ids[~alive] != -1).any():
        raise AssertionError(f"{tag}: ids {ids.tolist()} for alive {alive.tolist()}")
    for s in np.flatnonzero(alive):
        ring, ptr = age[s, 1:][age[s, 1:] >= 0], page[s][page[s] >= 0]
        if (age[s, 0] < 0 or len(set(ring.tolist())) != len(ring)
                or (ring >= num_maskmem - 1).any() or len(set(ptr.tolist())) != len(ptr)
                or (ptr >= max_obj_ptrs).any()):
            raise AssertionError(f"{tag}: slot {s} memory ages {age[s].tolist()}, "
                                 f"pointer ages {page[s].tolist()}")
    if not torch.isfinite(st.masks).all():
        raise AssertionError(f"{tag}: mask logits not finite")


def _slots(st: TrackState, idx: torch.Tensor, device) -> TrackState:
    """The slots ``idx`` of ``st`` on ``device`` (fp32 tensors)."""
    return TrackState(*(t.to(device) if t.dim() == 0 else t[idx.to(t.device)].to(device)
                        for t in st))


def tracker_against_cpu(core, st: TrackState, feats, poss, slots: torch.Tensor) -> dict:
    """``make_tracker_fns``' propagate and update_memory on ``core``'s
    device against the same stages in fp32 on the CPU (its weights copied),
    for the state's ``slots`` on one frame's features: the IoU predictions,
    SAM tokens, object logits and best masks (those whose best index agrees,
    or whose CPU margin is within SMALL_TOL), then the memory written from
    the same masks, logits and tokens. -> {output: max |device - cpu| / max
    |cpu| (the object logits over max(max |cpu|, 1))}, ``index_flips``:
    slots whose best mask differs, with their margin."""
    dev = slots.device
    cfg = core.spec.model
    cpu = video_tracker_core(cfg.replace(dtype="float32"), torch.device("cpu"), core.num_maskmem,
                             core.max_obj_ptrs)
    cpu.load_state_dict({k: v.cpu() for k, v in core.state_dict().items()})
    sides = []
    for c, device in ((core, dev), (cpu, torch.device("cpu"))):
        s = _slots(st, slots, device)
        f = [t.to(device).float() if device.type == "cpu" else t for t in feats]
        p = [t.to(device).float() if device.type == "cpu" else t for t in poss]
        prop, upd = make_tracker_fns(c, c.num_maskmem, c.max_obj_ptrs)
        sides.append((prop, upd, s, f, p))
    outs = [prop(s, f[-1], p[-1], f[0], f[1]) for prop, _, s, f, p in sides]
    (dm, dt, dl, di), (cm, ct, cl, ci) = [[t.float().cpu() for t in o] for o in outs]

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-12)

    # the object-score logits in logit units: the random heads give logits
    # of 1e-3-1e-2, a hundredth of the activations that make them, so their
    # bf16 error is measured against max(max |cpu|, 1), the sigmoid's scale
    logit_err = (dl - cl).abs().max().item() / max(cl.abs().max().item(), 1.0)
    res = {"iou": rel(di, ci), "obj_logits": logit_err, "tokens": rel(dt, ct)}
    same = di.argmax(-1) == ci.argmax(-1)
    top2 = ci.topk(2, dim=-1).values
    res["index_flips"] = [(int(i), float(top2[i, 0] - top2[i, 1])) for i in np.flatnonzero(~same)]
    res["masks"] = rel(dm[same], cm[same]) if same.any() else 0.0
    # the memory update from the same inputs on both sides
    masks, tokens = dm, dt
    logits = torch.where(sides[1][2].alive, 10.0, -10.0)
    new = [upd(s, f[-1], masks.to(f[-1].device), logits.to(f[-1].device), tokens.to(f[-1].device))
           for _, upd, s, f, _ in sides]
    a, b = [TrackState(*(t.float().cpu() if t.is_floating_point() else t.cpu() for t in n))
            for n in new]
    res["maskmem"], res["obj_ptrs"] = rel(a.maskmem, b.maskmem), rel(a.obj_ptrs, b.obj_ptrs)
    res["ages_equal"] = bool(torch.equal(a.maskmem_age, b.maskmem_age)
                             and torch.equal(a.obj_ptr_age, b.obj_ptr_age))
    return res


def video_ops_against_cpu(det_masks, det_scores, keep, st: TrackState,
                          fill_area: int = 16) -> dict:
    """``associate_det_trk`` (its mask IoU and the auction) and the batched
    connected components of the hole filling, on the tensors' device
    against the CPU on the same inputs. -> ({name: equal bit for bit}, the
    auction rounds the device's association ran)."""
    from sam3_lora_tpu_torch.train import matcher

    out = {}
    rounds = [0]
    one_round = matcher._auction_iteration

    def counted(*a):
        rounds[0] += 1
        return one_round(*a)

    matcher._auction_iteration = counted
    try:
        got = associate_det_trk(det_masks, st.masks, det_valid=keep, trk_valid=st.alive,
                                det_scores=det_scores, new_det_thresh=0.0)
    finally:
        matcher._auction_iteration = one_round
    want = associate_det_trk(det_masks.cpu(), st.masks.cpu(), det_valid=keep.cpu(),
                             trk_valid=st.alive.cpu(), det_scores=det_scores.cpu(),
                             new_det_thresh=0.0)
    for name, a, b in zip(got._fields, got, want):
        out[f"associate.{name}"] = torch.equal(a.cpu(), b)
    for name, m in (("foreground", st.masks > 0), ("background", st.masks <= 0)):
        out[f"connected_components.{name}"] = torch.equal(connected_components(m).cpu(),
                                                          connected_components(m.cpu()))
    out["fill_holes"] = torch.equal(fill_holes_in_mask_scores(st.masks, fill_area).cpu(),
                                    fill_holes_in_mask_scores(st.masks.cpu(), fill_area))
    return out, rounds[0]


def video_stage_seconds(vg: VideoGrounder, frame, prompt: str) -> dict:
    """Host seconds of each stage of one ``VideoGrounder.step``, each
    stage ended by a device sync: the backbone, the prompt's grounding,
    NMS, propagation, association, the memory update and the hole filling
    (0 on a frame with no spawn); ``other``, the rest of the step."""
    import sam3_lora_tpu_torch.video as vmod

    secs = dict.fromkeys(("set_image", "set_text_prompt", "nms", "propagate", "associate",
                          "update_memory", "fill_holes"), 0.0)
    stages = ((vg.proc, "set_image", "set_image"), (vg.proc, "set_text_prompt", "set_text_prompt"),
              (vmod, "nms_masks", "nms"), (vg, "_propagate", "propagate"),
              (vmod, "associate_and_update", "associate"), (vg, "_update_memory", "update_memory"),
              (vmod, "fill_holes_in_mask_scores", "fill_holes"))
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in stages]
    for (owner, name, label), (_, _, fn) in zip(stages, originals):
        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            secs[_label] += time.perf_counter() - t0
            return out

        setattr(owner, name, timed)
    try:
        total = host_seconds(lambda: vg.step(frame, prompt))[1]
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    secs["other"] = total - sum(secs.values())
    return secs


VEVAL = ("video_map", "phrase_ap", "video_cgf1", "phrase_hota", "teta")  # every SA-Co evaluator
VEVAL_SHIFT = 7  # pixels the "shifted" ground truth moves its first track by


def video_tracks(outs: list):
    """A grounder's per-frame outputs -> (N, T, h, w) bool masks and (N,)
    mean scores of every object id that has a mask in some frame (absent
    frames empty)."""
    ids = sorted({int(i) for o in outs for i in o["obj_ids"]})
    masks = np.zeros((len(ids), len(outs)) + outs[0]["masks_lowres"].shape[-2:], bool)
    total, seen = np.zeros(len(ids)), np.zeros(len(ids))
    for t, o in enumerate(outs):
        for j, i in enumerate(o["obj_ids"]):
            k = ids.index(int(i))
            masks[k, t] = o["masks_lowres"][j]
            total[k] += float(o["scores"][j])
            seen[k] += 1
    keep = masks.any(axis=(1, 2, 3))
    return masks[keep], (total / np.maximum(seen, 1))[keep]


def veval_ground_truth(masks: np.ndarray) -> dict:
    """A one-video, one-category YT-VIS ground truth whose tracks are
    ``masks`` (N, T, h, w)."""
    n, frames, h, w = masks.shape
    recs = saco_veval.prepare_video_predictions(0, np.ones(n), np.ones(n), masks=masks)
    keys = ("video_id", "category_id", "segmentations", "bboxes", "areas")
    return {"videos": [{"id": 0, "height": h, "width": w, "length": frames,
                        "file_names": [f"{t:05d}.jpg" for t in range(frames)]}],
            "annotations": [{"id": i + 1, "iscrowd": 0, "height": h, "width": w,
                             **{k: r[k] for k in keys}} for i, r in enumerate(recs)],
            "categories": [{"id": 1, "name": "crack"}],
            "video_np_pairs": [{"video_id": 0, "category_id": 1}]}


def saco_veval_check(outs: list, out_dir: str) -> dict:
    """The grounder's tracks as SA-Co prediction records
    (prepare_video_predictions), written as one shard by SacoVevalWriter
    and scored by its finalize against three ground truths: the tracks
    themselves, the tracks less the first, the first moved by VEVAL_SHIFT
    pixels. -> {ground truth: (meters, evaluator s, every meter equal to
    evaluate_saco_veval's on a copy of the records)}."""
    masks, scores = video_tracks(outs)
    records = saco_veval.prepare_video_predictions(0, scores, np.ones(len(scores)), masks=masks)
    writer = saco_veval.SacoVevalWriter(os.path.join(out_dir, "preds.json"), evaluators=VEVAL)
    writer.add_records(records)
    writer.write_shard(0)
    shifted = masks.copy()
    shifted[0] = np.roll(masks[0], (VEVAL_SHIFT, VEVAL_SHIFT), axis=(-2, -1))
    res = {}
    for name, gt_masks in (("self", masks), ("dropped", masks[1:]), ("shifted", shifted)):
        gt = veval_ground_truth(gt_masks)
        t0 = time.perf_counter()
        meters = writer.finalize(gt)
        secs = time.perf_counter() - t0
        ref, _ = saco_veval.evaluate_saco_veval(gt, copy.deepcopy(records), VEVAL)
        same = sorted(ref) == sorted(meters) and all(
            np.array_equal(meters[k], ref[k], equal_nan=True) for k in ref)
        res[name] = (meters, secs, same)
    return res


def check_saco_veval(tag: str, res: dict) -> None:
    """Each ground truth's meters equal to evaluate_saco_veval's on the
    copy; against the tracks themselves every video mAP and phrase AP 1.0."""
    self_ap = {k: v for k, v in res["self"][0].items() if "mAP" in k or "phrase_ap" in k}
    if not all(same for _, _, same in res.values()) or not self_ap or any(
            v != 1.0 for v in self_ap.values()):
        raise AssertionError(f"{tag}: saco_veval equal to the copy's "
                             f"{ {k: v[2] for k, v in res.items()} }, self-scored APs {self_ap}")


def phase_video(g: torch.Generator, smi: str):
    """VideoGrounder(propagate=True) on a bf16 Sam3Processor at the full
    config, 16 slots, 7 memory frames, 16 pointers, over VIDEO_FRAMES
    seeded 1200x900 frames with one prompt and prob_threshold 0 (random
    weights then fill the slots): each frame K1 x28, K2 x4, K3 x6 and no
    other kernel, finite logits, unique live ids, consistent ages; the
    tracker stages against their fp32 CPU run (SMALL_TOL), association and
    the batched connected components bit for bit the CPU's; the median
    host s per frame after a warm-up, one profiled frame, the memory
    attention's time in a propagated frame, peak memory. Then
    Sam3TrackerPredictor (a click, a box for a second object,
    propagate_in_video) and Sam3VideoPredictor (two sessions interleaved,
    the first again alone: equal outputs)."""
    tag = "video"
    proc = Sam3Processor(model_config(False), LORA, seed=SEED, device="cuda")
    cfg = proc.cfg
    live_adapters(proc.model, g)
    frames = video_frames(VIDEO_FRAMES)
    prompt = "crack"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vg = VideoGrounder(proc, num_slots=VIDEO_SLOTS, prob_threshold=0.0, propagate=True,
                       num_maskmem=VIDEO_MASKMEM, max_obj_ptrs=VIDEO_PTRS)
    secs, n_alive, evicted, outs = [], [], 0, []
    for i, frame in enumerate(frames):
        reset_counts()
        out, s = host_seconds(lambda: vg.step(frame, prompt))
        secs.append(s)
        outs.append(out)
        check_launches(f"{tag} frame {i}", counts(),
                       served(1, set_image_launches(cfg), prompt_launches(cfg)))
        check_track_state(f"{tag} frame {i}", vg.state, VIDEO_MASKMEM, VIDEO_PTRS)
        n_alive.append(len(out["obj_ids"]))
        # live slots whose ring has taken more writes than it holds
        evicted = max(evicted, int((vg.state.alive & (vg.state.maskmem_age[:, 1:] >= 0).all(dim=1)
                                    & (vg.state.hotstart >= VIDEO_MASKMEM)).sum()))
        if (set(out) != {"obj_ids", "scores", "masks_lowres"} or not np.isfinite(out["scores"]).all()
                or out["masks_lowres"].shape[1:] != (cfg.mask_loss_resolution,) * 2):
            raise AssertionError(f"{tag} frame {i}: bad output {[np.shape(v) for v in out.values()]}")
    peak = torch.cuda.max_memory_allocated()
    st = vg.state
    if int(st.frame_idx) != VIDEO_FRAMES or max(n_alive) != VIDEO_SLOTS or not evicted:
        raise AssertionError(f"{tag}: frame_idx {int(st.frame_idx)}, live objects {n_alive}, "
                             f"at most {evicted} slots past a ring eviction")
    med = statistics.median(secs[1:])
    prof = profile_step(lambda: vg.step(frames[0], prompt))
    split = video_stage_seconds(vg, frames[1], prompt)

    # the memory attention of one propagated frame, alone (CUDA events)
    feats, poss = proc._state["feats"], proc._state["poss"]
    core = vg.core
    with torch.inference_mode():
        mem, mpos, mmask, n_ptr, _ = memory_bank(core, st, VIDEO_MASKMEM, VIDEO_PTRS)
        visk, posk = (t.expand((VIDEO_SLOTS,) + t.shape[1:]) for t in (feats[-1], poss[-1]))
        mem_attn_ms = median_ms(lambda: core.condition_features(
            visk, posk, mem, mpos, mem_mask=mmask, num_obj_ptr_tokens=n_ptr), reps=3)
        prop_ms = median_ms(lambda: vg._propagate(st, feats[-1], poss[-1], feats[0], feats[1]),
                            reps=3)
    del mem, mpos, mmask
    print(f"{tag}: {VIDEO_FRAMES} frames at 1200x900, {VIDEO_SLOTS} slots, {VIDEO_MASKMEM} memory "
          f"frames, {VIDEO_PTRS} pointers, live objects a frame {n_alive}, at most {evicted} live "
          f"slots past a ring eviction in a frame; host s a frame, median after the first {med:.4f} "
          f"{fmt_s(secs)}; profile (one frame, torch.profiler): {prof['device_ms']:.3f} device ms "
          f"in a {prof['window_ms']:.3f} ms window, busy share {prof['busy_share']:.4f}; "
          f"propagate {prop_ms:.3f} ms, of which the memory attention {mem_attn_ms:.3f} ms "
          f"(CUDA events, median of 3; {mem_attn_ms / prof['device_ms']:.4f} of the frame's "
          f"device ms); peak memory {peak / 2**30:.3f} GiB | {smi}", flush=True)
    print(f"{tag}: host s of one frame's stages, each ended by a sync: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" | {smi}", flush=True)

    # the stages against the CPU, on the last frame's state and features
    live = torch.nonzero(st.alive).flatten()[:VIDEO_CPU_SLOTS]
    res = tracker_against_cpu(core, st, feats, poss, live)
    print(f"{tag}: the card's tracker stages (bf16) against their fp32 CPU run on slots "
          f"{live.tolist()}: max |card - cpu| / max |cpu| " + ", ".join(
              f"{k} {v:.5f}" for k, v in res.items() if isinstance(v, float))
          + f"; best-mask index flips {res['index_flips']}; ages equal {res['ages_equal']} "
          f"(limit {SMALL_TOL})", flush=True)
    bad = [k for k, v in res.items() if isinstance(v, float) and v > SMALL_TOL]
    flips = [m for _, m in res["index_flips"] if m > SMALL_TOL]
    if bad or flips or not res["ages_equal"]:
        raise AssertionError(f"{tag}: tracker stages off the CPU's: {res}")
    dets = proc.set_text_prompt(prompt, threshold=-1.0)
    dm = torch.from_numpy(dets["masks_lowres"].astype(np.float32)).to(proc.device)
    ds = torch.from_numpy(dets["scores"].astype(np.float32)).to(proc.device)
    keep = nms_ops.nms_masks(dm, ds, vg.nms_iou)
    eq, rounds = video_ops_against_cpu(dm, ds, keep, st)
    print(f"{tag}: association ({dm.shape[0]} detections x {VIDEO_SLOTS} tracks at "
          f"{cfg.mask_loss_resolution}^2, the auction: {rounds} rounds, 8 a host sync) and the "
          f"batched connected components on the card against the CPU, bit for bit: {eq}",
          flush=True)
    if not all(eq.values()):
        raise AssertionError(f"{tag}: card and CPU differ: {eq}")
    with tempfile.TemporaryDirectory() as out_dir:
        veval = saco_veval_check(outs, out_dir)
    n_tracks = len(video_tracks(outs)[1])
    print(f"{tag}: saco_veval of the grounder's {n_tracks} tracks over {VIDEO_FRAMES} frames "
          f"(SacoVevalWriter, one shard, every evaluator) against ground truth of the tracks "
          f"themselves, less the first, the first moved {VEVAL_SHIFT} px: "
          + "; ".join(f"{name} {secs_:.3f} evaluator s, equal to the CPU copy's {same}, "
                      + ", ".join(f"{k} {meters[k]:.4f}" for k in (
                          "video_mask_mAP_50_95", "video_mask_phrase_ap_50_95",
                          "video_mask_demo_cgf1_micro_50_95", "video_mask_all_phrase_HOTA",
                          "video_bbox_teta"))
                      for name, (meters, secs_, same) in veval.items()), flush=True)
    check_saco_veval(tag, veval)
    del vg, core, st, dm, ds, keep
    torch.cuda.empty_cache()

    # Sam3TrackerPredictor: a click on frame 0, a box for a second object,
    # then propagation over every frame
    tp = Sam3TrackerPredictor(proc, num_maskmem=VIDEO_MASKMEM, max_obj_ptrs=VIDEO_PTRS)
    tp.init_state(frames)
    _, m0 = tp.add_new_points_or_box(0, obj_id=1, points=np.array([[600.0, 450.0]]),
                                     labels=np.array([1]))
    _, m1 = tp.add_new_points_or_box(0, obj_id=2, box=np.array([100.0, 100.0, 500.0, 400.0]))
    reset_counts()
    outs, t_track = host_seconds(lambda: list(tp.propagate_in_video()))
    check_launches(f"{tag} tracker predictor", counts(),
                   served(VIDEO_FRAMES - 1, set_image_launches(cfg)))
    tr = tp._state.track
    ring = tr.maskmem_age[:2, 1:].cpu().numpy()
    if (len(outs) != VIDEO_FRAMES or any(sorted(o[1].tolist()) != [1, 2] for o in outs)
            or not all(np.isfinite(o[2]).all() for o in outs)
            or not (np.isfinite(m0).all() and np.isfinite(m1).all())
            or (tr.maskmem_age[:2, 0] < 0).any() or not (ring >= 0).all()):
        raise AssertionError(f"{tag}: tracker predictor outputs {[o[1].tolist() for o in outs]}, "
                             f"ring ages {ring.tolist()}")
    print(f"{tag}: Sam3TrackerPredictor, a click and a box on frame 0, then propagate_in_video "
          f"over {len(outs)} frames in {t_track:.4f} s (K1/K2 once a new frame), finite, cond and "
          f"ring memory written (ring ages {ring.tolist()})", flush=True)
    del tp
    torch.cuda.empty_cache()

    # Sam3VideoPredictor: two sessions interleaved, then the first alone
    vp = Sam3VideoPredictor(proc, propagate_memory=True, num_slots=VIDEO_SLOTS,
                            prob_threshold=0.0, num_maskmem=VIDEO_MASKMEM, max_obj_ptrs=VIDEO_PTRS)
    n = 3
    a, b = vp.start_session(frames[:n]), vp.start_session(frames[n:2 * n])
    vp.add_prompt(a, prompt)
    vp.add_prompt(b, "wall")
    inter = [(oa, ob) for oa, ob in zip(vp.propagate_in_video(a), vp.propagate_in_video(b))]
    vp.add_prompt(a, prompt)
    alone = list(vp.propagate_in_video(a))
    same = all(np.array_equal(x["obj_ids"], y["obj_ids"])
               and np.array_equal(x["masks_lowres"], y["masks_lowres"])
               for (x, _), y in zip(inter, alone))
    finite = all(np.isfinite(o["scores"]).all() for pair in inter for o in pair)
    print(f"{tag}: Sam3VideoPredictor, 2 sessions of {n} frames interleaved: finite {finite}, "
          f"the first session's outputs equal to its run alone {same}", flush=True)
    if not (same and finite and [o["frame_idx"] for o, _ in inter] == list(range(n))):
        raise AssertionError(f"{tag}: interleaved sessions differ from the session alone")
    vp.close()
    del vp, proc
    torch.cuda.empty_cache()


# the video-train phase: one clip of VT_STAGES frames from make_synthetic_ytvis
# (2 videos of VT_FRAMES frames, written at VT_IMG^2 and resized to the
# model's input), the point-sampled mask loss at the reference's 12544 points
VT_FRAMES, VT_STAGES, VT_IMG, VT_POINTS = 12, 4, 576, 12544
VT_Q_TRK = 16      # the association losses' track queries
VT_RTOL = 1e-5     # a video loss in fp32 on the card against the same on the CPU
VT_LOSSES = ("loss_semantic_seg", "loss_semantic_dice", "loss_semantic_presence", "loss_mask",
             "loss_dice")


def video_clip(cfg: ModelConfig, root: str, stages: int = VT_STAGES):
    """One training clip (``VideoSample``) of ``stages`` frames, sampled at
    random strides by VideoGroundingDataset from the first of the 2 videos
    of VT_FRAMES frames that make_synthetic_ytvis writes under ``root``."""
    make_synthetic_ytvis(root, num_videos=2, num_frames=VT_FRAMES, img_size=VT_IMG, seed=SEED)
    ds = VideoGroundingDataset(root, model_config=cfg, num_stages=stages, training=True, seed=SEED)
    return ds.load(0)


def clip_batch(cfg: ModelConfig, clip) -> Batch:
    """The clip's frames as one batch of CPU tensors: each frame with the
    clip's text, no box prompt, and its targets."""
    from sam3_lora_tpu_torch.models.tokenizer import get_default_tokenizer

    t = clip.frames.shape[0]
    ids = get_default_tokenizer()([clip.text] * t, context_length=cfg.text_context_length)
    as_t = torch.from_numpy
    return Batch(images=as_t(clip.frames), token_ids=as_t(np.asarray(ids, np.int64)),
                 img_ids=torch.arange(t), geo=GeoPrompt.empty(t, cfg.max_prompt_boxes),
                 targets=Targets(boxes=as_t(clip.boxes), valid=as_t(clip.valid),
                                 masks=as_t(clip.masks), mask_valid=as_t(clip.mask_valid),
                                 is_exhaustive=torch.ones((t,), dtype=torch.bool)))


def matched_pairs(out: dict, targets: Targets) -> torch.Tensor:
    """(B, T) bool: the target slots with a mask that the last layer's
    matching (train/matcher.py, inside the forward) gave a query."""
    return (out["indices"][-1] >= 0) & targets.valid & targets.mask_valid


def clip_losses(out: dict, targets: Targets, draws) -> dict:
    """The video tier's losses on a clip's outputs: semantic_seg_loss on the
    semantic head, the instance masks and the last layer's presence logit;
    point_sampled_mask_loss (VT_POINTS points at ``draws``) on the matched
    queries' masks against their targets."""
    pair = matched_pairs(out, targets)
    losses = video_losses.semantic_seg_loss(out["semantic_seg"], targets.masks.float(),
                                            targets.mask_valid,
                                            presence_logit=out["presence_logit_dec"][-1])
    losses.update(video_losses.point_sampled_mask_loss(
        out["pred_masks_matched"][pair], targets.masks[pair].float(), float(draws[0].shape[0]),
        num_points=VT_POINTS, draws=draws))
    return losses


def card_against_cpu(fn, args, diff, keys, device) -> dict:
    """``fn(*args)`` -> a dict of losses, run on ``device`` and on the CPU on
    the same values, in fp32; the ``args`` at the indices ``diff`` are leaves
    with gradients. -> {key: (value on ``device``, |value - cpu| / |cpu|,
    max |grad - cpu grad| / max |cpu grad| over the leaves)}."""
    runs = []
    for dev in (device, "cpu"):
        xs = [a.detach().to(dev).float().requires_grad_() if i in diff else a.to(dev)
              for i, a in enumerate(args)]
        out = fn(*xs)
        leaves = [xs[i] for i in diff]
        runs.append({k: (out[k].detach().cpu(), [
            (torch.zeros_like(x) if g is None else g).cpu() for x, g in zip(leaves, torch.autograd.grad(
                out[k], leaves, retain_graph=True, allow_unused=True))]) for k in keys})
    res = {}
    for k in keys:
        (v, gs), (ref, ref_gs) = runs[0][k], runs[1][k]
        val_err = abs(float(v) - float(ref)) / (abs(float(ref)) or 1.0)
        grad_err = max(float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
                       for g, r in zip(gs, ref_gs))
        res[k] = (float(v), val_err, grad_err)
    return res


def assoc_inputs(out: dict, targets: Targets, track_ids: np.ndarray, g: torch.Generator):
    """Seeded association logits (Q_det = the model's queries, VT_Q_TRK
    tracks) and matched ids from the clip: each matched query carries its
    slot's track id; the tracks are the clip's live ids and one of them
    again (a duplicated id). -> (det2trk args, tracking-by-detection args)
    as CPU tensors."""
    idx = out["indices"][-1].cpu()
    pair = matched_pairs(out, targets).cpu()
    b, q_det = out["pred_logits"].shape[1:3]
    det = torch.full((b, q_det), -1, dtype=torch.long)
    rows, slots = torch.nonzero(pair, as_tuple=True)
    det[rows, idx[rows, slots]] = torch.from_numpy(track_ids.astype(np.int64))[slots]
    live = track_ids[track_ids >= 0]
    trk = np.full((b, VT_Q_TRK), -1, np.int64)
    trk[:, :len(live)] = live
    trk[:, len(live)] = live[0]
    trk = torch.from_numpy(trk)
    d2t = 3.0 * torch.randn((b, q_det, VT_Q_TRK + 2), generator=g)
    tbd = 3.0 * torch.randn((b, q_det + 1, VT_Q_TRK + 1), generator=g)
    pred_logits = out["pred_logits"][-1][..., 0].detach().float().cpu()
    return (d2t, det, trk, pred_logits), (tbd, det, trk)


def det2trk(logits, det, trk, pred_logits):
    return video_losses.det2trk_assoc_loss(logits, det, trk, 2.0, pred_logits=pred_logits,
                                           is_exhaustive=torch.ones(det.shape[0], dtype=torch.bool,
                                                                    device=det.device),
                                           use_fp_loss=True)


def tracking_by_detection(logits, det, trk):
    return video_losses.tracking_by_detection_assoc_loss(logits, det, trk, 2.0)


def error_points(out: dict, targets: Targets, side: int) -> dict:
    """sample_point_from_error_region on the outputs' device against the
    CPU: the first matched query's mask logits against its target at the
    mask resolution, and both resized to ``side`` (bilinear, nearest). ->
    {size: ((y, x), positive, equal to the CPU's)}."""
    from sam3_lora_tpu_torch.ops.interpolate import resize_bilinear, resize_nearest

    pair = matched_pairs(out, targets)
    pred = out["pred_masks_matched"][pair][0].detach().float()
    gt = targets.masks[pair][0].float()
    res = {}
    for p, t in ((pred, gt), (resize_bilinear(pred, (side, side)), resize_nearest(gt, (side, side)))):
        yx, pos = sample_point_from_error_region(p, t)
        ref_yx, ref_pos = sample_point_from_error_region(p.cpu(), t.cpu())
        res[p.shape[-1]] = (yx.tolist(), bool(pos),
                            torch.equal(yx.cpu(), ref_yx) and bool(pos) == bool(ref_pos))
    return res


def video_train_step(model, cfg: ModelConfig, clip, device) -> dict:
    """One forward of the clip's frames in train mode (matching inside),
    the video losses and one backward into the adapters; the launches of
    the forward and of the whole step; then each loss and the error-region
    sampler on ``device`` against the CPU. Returns what the phase prints
    and checks."""
    named = trainable_parameters(model)
    model.zero_grad(set_to_none=True)
    model.train()
    model.seed_dropout(SEED)
    batch = batch_to_device(clip_batch(cfg, clip), device)
    sync = sync_of(device)
    reset_counts()
    t0 = time.perf_counter()
    out = model(batch)
    fwd = counts()
    pair = matched_pairs(out, batch.targets)
    n_pairs = int(pair.sum())
    if not n_pairs:
        raise AssertionError("video-train: the matching paired no target that has a mask")
    cpu_gen = torch.Generator().manual_seed(SEED)
    draws = video_losses.draw_point_uniforms(n_pairs, VT_POINTS, generator=cpu_gen)
    losses = clip_losses(out, batch.targets, tuple(d.to(device) for d in draws))
    sum(losses[k] for k in VT_LOSSES).backward()
    sync()
    step_s = time.perf_counter() - t0
    step = counts()
    grads = [p.grad for _, p in named if p.grad is not None]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    nonzero = sum(bool(g.abs().max() > 0) for g in grads)

    # each loss on the card against the CPU, on the same detached logits,
    # targets and draws
    t = batch.targets
    args = (out["semantic_seg"], out["presence_logit_dec"][-1], out["pred_masks_matched"][pair],
            t.masks.float(), t.mask_valid, t.masks[pair].float(), *draws)

    def seg_and_points(sem, pres, pred, masks, mask_valid, gt, cand, rand):
        res = video_losses.semantic_seg_loss(sem, masks, mask_valid, presence_logit=pres)
        res.update(video_losses.point_sampled_mask_loss(pred, gt, float(n_pairs),
                                                        num_points=VT_POINTS, draws=(cand, rand)))
        return res

    cpu_losses = card_against_cpu(seg_and_points, [a.detach() for a in args], (0, 1, 2),
                                  VT_LOSSES, device)
    d2t_args, tbd_args = assoc_inputs(out, t, clip.track_ids, cpu_gen)
    cpu_losses.update(card_against_cpu(det2trk, d2t_args, (0,), ("loss_det2trk_assoc",), device))
    tbd = card_against_cpu(tracking_by_detection, tbd_args, (0,),
                           ("loss_det2trk_assoc", "loss_trk2det_assoc"), device)
    cpu_losses.update({"tbd_" + k: v for k, v in tbd.items()})
    points = error_points(out, t, cfg.img_size)

    # the losses' device ms (CUDA events on the card; the host clock on the CPU)
    dev = "cpu" if device == "cpu" else "cuda"
    on_dev = [a.detach().to(device) for a in args]
    d2t_dev = [a.to(device) for a in d2t_args]
    tbd_dev = [a.to(device) for a in tbd_args]
    pred_big = on_dev[2][0].float()
    loss_ms = {
        "semantic_seg_loss": median_ms(lambda: video_losses.semantic_seg_loss(
            on_dev[0], on_dev[3], on_dev[4], presence_logit=on_dev[1]), reps=5, device=dev),
        "point_sampled_mask_loss": median_ms(lambda: video_losses.point_sampled_mask_loss(
            on_dev[2], on_dev[5], float(n_pairs), num_points=VT_POINTS,
            draws=(on_dev[6], on_dev[7])), reps=5, device=dev),
        "det2trk_assoc_loss": median_ms(lambda: det2trk(*d2t_dev), reps=5, device=dev),
        "tracking_by_detection_assoc_loss": median_ms(lambda: tracking_by_detection(*tbd_dev),
                                                      reps=5, device=dev),
        "sample_point_from_error_region": median_ms(lambda: sample_point_from_error_region(
            pred_big, on_dev[5][0]), reps=5, device=dev),
    }
    return {"fwd": fwd, "step": step, "step_s": step_s, "pairs": n_pairs,
            "losses": {k: float(v.detach()) for k, v in losses.items()}, "finite": finite,
            "nonzero": nonzero, "adapters": len(named), "cpu": cpu_losses, "points": points,
            "loss_ms": loss_ms}


def check_video_train(tag: str, cfg: ModelConfig, res: dict) -> None:
    """The step's launches (the forward K1, K2, K3 once a layer; the step the
    train phase's design), finite losses, finite adapter gradients of which
    some are nonzero, each loss within VT_RTOL of the CPU's (value and
    gradient), the sampler's points equal to the CPU's."""
    n_global = len(cfg.vit_global_blocks)
    check_launches(f"{tag} forward", res["fwd"],
                   {"window_attention_rope_packed": cfg.vit_depth - n_global,
                    "long_attention_rope_packed": n_global, "long_attention_packed": cfg.enc_layers})
    check_launches(f"{tag} step", res["step"], train_step_launches(cfg))
    bad = {k: v for k, v in res["cpu"].items() if not (v[1] <= VT_RTOL and v[2] <= VT_RTOL)}
    if (not all(np.isfinite(v) for v in res["losses"].values()) or not res["finite"]
            or not res["nonzero"] or bad or not all(p[2] for p in res["points"].values())):
        raise AssertionError(f"{tag}: losses {res['losses']}, gradients finite {res['finite']}, "
                             f"{res['nonzero']} nonzero; off the CPU's: {bad}; error points "
                             f"{res['points']}")


def phase_video_train(g: torch.Generator, smi: str):
    """The video tier's training losses on the full config's own outputs
    (bf16, LORA's adapters drawn live): one clip of VT_STAGES frames at
    1008^2 through the model in train mode as a batch, semantic_seg_loss
    and point_sampled_mask_loss (VT_POINTS points) on its outputs, one
    backward; launches, finite losses and gradients; each loss, the two
    association losses on seeded logits with the clip's track ids, and the
    error-region sampler on the card against the CPU."""
    tag = "video-train"
    cfg = model_config(False)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        clip = video_clip(cfg, root)
        data_s = time.perf_counter() - t0
    model = build_sam3_image_model(cfg, lora=LORA, device="cuda")
    init_model(model, torch.Generator(device="cuda").manual_seed(SEED))
    live_adapters(model, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = video_train_step(model, cfg, clip, "cuda")
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag}: clip of {VT_STAGES} frames ({clip.frames.shape[-1]}^2, text {clip.text!r}, "
          f"{int((clip.track_ids >= 0).sum())} tracks, masks at {clip.masks.shape[-1]}^2) loaded "
          f"in {data_s:.3f} s; {res['pairs']} matched pairs; step (forward, losses, backward) "
          f"{res['step_s']:.4f} host s, peak {peak / 2**30:.3f} GiB; losses "
          + ", ".join(f"{k} {v:.5f}" for k, v in res["losses"].items())
          + f"; {res['nonzero']} of {res['adapters']} adapter gradients nonzero; launches "
          f"{ {k: v for k, v in res['step'].items() if v} } | {smi}", flush=True)
    print(f"{tag}: each loss on the card against the CPU in fp32 (value rel err, gradient err "
          f"over the largest CPU gradient; limit {VT_RTOL}): "
          + ", ".join(f"{k} {e:.2e} {ge:.2e}" for k, (_, e, ge) in res["cpu"].items())
          + f"; error-region points (size: (y, x), positive, equal) {res['points']}; device ms "
          + ", ".join(f"{k} {v:.4f}" for k, v in res["loss_ms"].items()) + f" | {smi}",
          flush=True)
    check_video_train(tag, cfg, res)
    del model
    torch.cuda.empty_cache()


def phase_int8_bwd(g: torch.Generator):
    """One full-width training step at the bench configuration with
    ``base_quant="int8_bwd"`` (dx also an int8 product)."""
    cfg = bench_model_config().replace(base_quant="int8_bwd")
    launches = fit("int8_bwd", g, cfg, bench_lora_config(), BENCH_BATCH, 1)[0]
    if not launches["int8_gemm_wres"]:
        raise AssertionError("int8_bwd: no int8 GEMM ran")


# the scale-out phase: batch 4 with every dropout off (the ranks of (b) draw
# their own masks, which (a) would not), one warm-up and two timed updates
SCALE_BATCH, SCALE_STEPS = 4, 3
SCALE_RANKS = 2
SCALE_RANK_TIMEOUT_S = 420
SCALE_FRAMES, SCALE_CHUNK = 8, 4


def scale_out_config() -> ModelConfig:
    return model_config(False).replace(enc_dropout=0.0, dec_dropout=0.0, vit_drop_path_rate=0.0)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fit_recording(cfg: ModelConfig, loader, out_dir: str):
    """Trainer.fit over ``loader`` at ``cfg`` with LORA, live adapters drawn
    from a generator seeded SEED and the scorer's dropout off. -> (trainer,
    adapters after each update, the first update's gradients after the
    group's reduction and before the clip, fit's result)."""
    from sam3_lora_tpu_torch.train import trainer as trainer_mod

    tcfg = TrainConfig(batch_size=loader.bs, num_epochs=1, warmup_steps=0, logging_steps=1,
                       num_workers=2, seed=SEED, output_dir=out_dir)
    trainer = Trainer(cfg, LORA, tcfg, device="cuda")
    trainer.setup(steps_per_epoch=len(loader))
    live_adapters(trainer.model, torch.Generator(device="cuda").manual_seed(SEED))
    trainer.model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0
    snaps, grads = [], {}
    step, update = trainer.train_step, trainer_mod.apply_update

    def recording_step(batch):
        losses = step(batch)
        snaps.append([p.detach().clone() for p in trainer.trainable])
        return losses

    def capturing_update(opt, params, lr, max_norm):
        if not grads:
            grads.update({n: p.grad.float().cpu() for n, p in zip(trainer.trainable_names, params)})
        return update(opt, params, lr, max_norm)

    trainer.train_step = recording_step
    trainer_mod.apply_update = capturing_update
    try:
        result = trainer.fit(loader)
    finally:
        trainer_mod.apply_update = update
    torch.cuda.synchronize()
    return trainer, snaps, grads, result


def read_stats(out_dir: str) -> list:
    with open(os.path.join(out_dir, "train_stats.json")) as f:
        return [json.loads(line) for line in f]


def snapshot_diff(names, a, b) -> list:
    """(update, adapter, max |a - b|) of every adapter whose bits differ."""
    return [(i, n, (x.float() - y.float()).abs().max().item())
            for i, (sa, sb) in enumerate(zip(a, b)) for n, x, y in zip(names, sa, sb)
            if not torch.equal(x, y)]


def scale_out_rank(base: str) -> None:
    """One rank of scale-out (b), run by the phase as ``chip_smoke.py
    --scale-out-rank <dir>`` with the group's environment: gloo over CUDA
    tensors on the one card, TRAIN_BATCH / SCALE_RANKS of the first update's
    images, one update; its reduced gradients, adapters after the update and
    the files its trainer wrote go to ``<dir>/rank<r>.pt``."""
    from sam3_lora_tpu_torch.parallel import multihost

    if not multihost.initialize(backend="gloo"):
        raise SystemExit("scale-out rank: no process group in the environment")
    rank = multihost.process_index()
    try:
        cfg = scale_out_config()
        loader = DataLoader(SyntheticSamples(cfg, SCALE_BATCH, SEED), SCALE_BATCH // SCALE_RANKS,
                            shuffle=False, num_workers=2, host_shard=multihost.host_shard())
        out_dir = os.path.join(base, f"out{rank}")
        trainer, snaps, grads, result = fit_recording(cfg, loader, out_dir)
        written = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                         for d, _, files in os.walk(out_dir) for f in files)
        torch.save({"grads": grads, "adapters": [t.cpu() for t in snaps[-1]],
                    "names": trainer.trainable_names, "steps": result["steps"],
                    "written": written,
                    "peak": torch.cuda.max_memory_allocated()}, os.path.join(base, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()
    print(f"scale-out rank {rank}: done", flush=True)


def run_ranks(base: str, flag: str = "--scale-out-rank", name: str = "rank",
              tag: str = "(b)") -> list:
    """SCALE_RANKS processes of this script with ``flag`` (``scale_out_rank``,
    or ``fsdp_rank``) on the one card; each rank's ``<base>/<name><r>.pt``.
    Raises if any fails or outlasts SCALE_RANK_TIMEOUT_S."""
    import sys

    port = free_port()
    procs = []
    for r in range(SCALE_RANKS):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(SCALE_RANKS), "RANK": str(r), "LOCAL_RANK": "0"}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, base], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs, failed = [], []
    try:
        deadline = time.perf_counter() + SCALE_RANK_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} timed out after {SCALE_RANK_TIMEOUT_S} s")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            failed.append(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    if failed:
        raise AssertionError(f"scale-out {tag}: " + "\n".join(failed))
    return [torch.load(os.path.join(base, f"{name}{r}.pt")) for r in range(SCALE_RANKS)]


def split_reference(cfg: ModelConfig, loader) -> dict:
    """(b) in one process: the first batch of ``loader`` split by image into
    the ranks' halves (``parallel.shard_batch``), each half's loss over the
    two halves' summed counts (``train/losses.py::_group_sum`` given them in
    place of the collective), the mean of the halves' adapter gradients;
    whether the halves' matching equals the whole batch's, and their scores'
    largest distance from the whole batch's (every layer, in probability).
    -> {"grads": {name: fp32 cpu}, "matching_equal": bool, "scores": float}."""
    from sam3_lora_tpu_torch.parallel import make_mesh, shard_batch
    from sam3_lora_tpu_torch.train import losses as losses_mod

    tcfg = TrainConfig(batch_size=loader.bs, num_epochs=1, seed=SEED,
                       output_dir=tempfile.mkdtemp())
    trainer = Trainer(cfg, LORA, tcfg, device="cuda")
    trainer.setup(steps_per_epoch=len(loader))
    live_adapters(trainer.model, torch.Generator(device="cuda").manual_seed(SEED))
    model = trainer.model
    model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0
    model.train()
    batch = batch_to_device(next(iter(loader.epoch(0))), "cuda")
    halves = [shard_batch(batch, make_mesh(ranks=range(SCALE_RANKS)), rank=r)
              for r in range(SCALE_RANKS)]
    local, orig = [], losses_mod._group_sum
    try:
        with torch.no_grad():
            whole = model(batch)
            losses_mod._group_sum = lambda v: (local.append(v), (v, 1))[1]
            parts = []
            for h in halves:
                out = model(h)
                parts.append((out["indices"], out["pred_logits"]))
                compute_losses(out, h.targets)
        matching_equal = torch.equal(torch.cat([i for i, _ in parts], dim=1), whole["indices"])
        scores_diff = (torch.sigmoid(torch.cat([s for _, s in parts], dim=1).float())
                       - torch.sigmoid(whole["pred_logits"].float())).abs().max().item()
        del whole, parts
        total = sum(local[1:], local[0])
        losses_mod._group_sum = lambda v: (total, SCALE_RANKS)
        model.zero_grad(set_to_none=True)
        for h in halves:
            compute_losses(model(h), h.targets)["core_loss"].backward()
    finally:
        losses_mod._group_sum = orig
    grads = {n: (p.grad / SCALE_RANKS).float().cpu()
             for n, p in zip(trainer.trainable_names, trainer.trainable)}
    del trainer, model, batch, halves
    torch.cuda.empty_cache()
    return {"grads": grads, "matching_equal": matching_equal, "scores": scores_diff}


def scale_out_frames(cfg: ModelConfig, g: torch.Generator):
    """(c): FrameParallelDetector at world size 1 over SCALE_FRAMES seeded
    1200x900 frames, one prompt, chunk SCALE_CHUNK, against ``_forward`` on
    each frame alone. -> (launches, graph_delta, max errors, host s a frame:
    detector, the loop)."""
    from sam3_lora_tpu_torch.parallel import FrameParallelDetector

    engine = SAM3LoRAInference(cfg, LORA, seed=SEED, device="cuda")
    live_adapters(engine.model, g)
    frames = [engine.preprocess(f)[0][0] for f in video_frames(SCALE_FRAMES)]
    ids = np.asarray(engine.tokenizer(PROMPTS[0], context_length=cfg.text_context_length),
                     np.int64)[0]
    det = FrameParallelDetector(SAM3LoRAInference._forward, engine, chunk_size=SCALE_CHUNK)
    list(det.detect_video(frames[:SCALE_CHUNK], ids))  # warm-up: the batch-4 shapes
    torch.cuda.synchronize()
    reset_counts()
    outs, det_s = host_seconds(lambda: list(det.detect_video(frames, ids)))
    launches, delta = counts(), graph_delta()

    def alone():
        return [[t.cpu().numpy() for t in engine._forward(
            torch.from_numpy(f[None]).cuda(), torch.from_numpy(ids[None]).cuda())] for f in frames]

    ref, loop_s = host_seconds(alone)
    names = ("scores", "presence", "boxes", "masks")
    errs = {n: max(float(np.abs(o[i] - r[i][0]).max()) for o, r in zip(outs, ref))
            for i, n in enumerate(names)}
    if len(outs) != SCALE_FRAMES:
        raise AssertionError(f"scale-out (c): {len(outs)} frames out of {SCALE_FRAMES}")
    del engine, det
    torch.cuda.empty_cache()
    return launches, delta, errs, det_s / SCALE_FRAMES, loop_s / SCALE_FRAMES


def scale_out_checkpoint(base: str) -> dict:
    """(d): save_base_checkpoint of a full-config model, loaded strictly into
    a fresh model (every parameter bit for bit); an int8-tier engine built
    from the file against one quantized from the same weights directly, one
    request's raw outputs bit for bit."""
    from sam3_lora_tpu_torch.utils.checkpoint import load_base_checkpoint, save_base_checkpoint

    cfg = model_config(False)
    path = os.path.join(base, "base.npz")
    src = SAM3LoRAInference(cfg, None, seed=SEED + 1, device="cuda")
    t0 = time.perf_counter()
    n = save_base_checkpoint(src.model, path)
    save_s = time.perf_counter() - t0
    fresh = build_sam3_image_model(cfg, device="cuda")
    init_model(fresh, torch.Generator(device="cuda").manual_seed(SEED))
    t0 = time.perf_counter()
    load_base_checkpoint(fresh, path, strict=True)
    load_s = time.perf_counter() - t0
    want = dict(src.model.named_parameters())
    differ = [k for k, p in fresh.named_parameters() if not torch.equal(p, want[k])]
    del src, fresh, want
    torch.cuda.empty_cache()

    cfg8 = model_config(True)
    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    outs = []
    for kw in (dict(base_checkpoint=path), dict(seed=SEED + 1)):
        engine = SAM3LoRAInference(cfg8, None, device="cuda", **kw)
        img, _ = engine.preprocess(image)
        ids = engine.tokenizer(PROMPTS[-1], context_length=cfg8.text_context_length)
        outs.append([t.cpu() for t in engine._forward(
            torch.from_numpy(img).cuda(), torch.from_numpy(np.asarray(ids, np.int64)).cuda())])
        del engine
        torch.cuda.empty_cache()
    int8_equal = all(torch.equal(a, b) for a, b in zip(*outs))
    size = os.path.getsize(path)
    os.remove(path)
    return {"arrays": n, "bytes": size, "save_s": save_s, "load_s": load_s, "differ": differ,
            "int8_equal": int8_equal}


def fsdp_config() -> ModelConfig:
    return scale_out_config().replace(base_quant="int8")


def param_bytes(model: torch.nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def fsdp_trainer(cfg: ModelConfig, loader, out_dir: str):
    """A Trainer at ``cfg`` with LORA, set up (the base prequantized), live
    adapters drawn from a generator seeded SEED, the scorer's dropout off;
    and the loader's first batch on the card."""
    trainer = Trainer(cfg, LORA, TrainConfig(batch_size=loader.bs, seed=SEED, output_dir=out_dir),
                      device="cuda")
    trainer.setup(steps_per_epoch=1)
    live_adapters(trainer.model, torch.Generator(device="cuda").manual_seed(SEED))
    trainer.model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0
    return trainer, batch_to_device(next(iter(loader.epoch(0))), "cuda")


def fsdp_update(trainer, batch) -> dict:
    """One update's forward and backward (``train_step``) and the group's
    mean gradient (``all_reduce_mean_``), as ``Trainer.train_step`` runs
    them: the losses and gradients on the host, the launches, the gathers
    in the forward and the backward, the peak bytes and the host s."""
    from sam3_lora_tpu_torch.parallel import dist_utils, fsdp

    model = trainer.model
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fsdp.GATHERS.update(forward=0, backward=0)
    t0 = time.perf_counter()
    losses = train_step(model, batch, trainer.loss_cfg)
    dist_utils.all_reduce_mean_([p.grad for p in trainer.trainable])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    return {"losses": {k: v.float().cpu() for k, v in losses.items()},
            "grads": [p.grad.float().cpu() for p in trainer.trainable],
            "launches": counts(), "gathers": dict(fsdp.GATHERS),
            "peak": torch.cuda.max_memory_allocated(), "host_s": host_s,
            "bytes": param_bytes(model)}


def shard_base(model: torch.nn.Module):
    """Place the base by JAX's rule over the group's data axis
    (``shard_params_``); -> (leaves split, the bytes the rule leaves this
    rank, counted before the placement)."""
    from sam3_lora_tpu_torch.parallel import make_mesh, param_shardings, shard_params_
    from sam3_lora_tpu_torch.parallel.mesh import DATA_AXIS

    mesh = make_mesh()
    shardings = param_shardings(model, mesh, shard_base=True)
    n = mesh.shape[DATA_AXIS]
    predicted = sum(p.numel() * p.element_size() // (n if DATA_AXIS in shardings[k].spec else 1)
                    for k, p in model.named_parameters())
    split = shard_params_(model, shardings)
    torch.cuda.empty_cache()
    return split, predicted


def same_update(a: dict, b: dict) -> bool:
    return (all(torch.equal(a["losses"][k], b["losses"][k]) for k in a["losses"])
            and all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"])))


def fsdp_rank(base: str) -> None:
    """One rank of scale-out (f2), run as ``chip_smoke.py --fsdp-rank
    <dir>`` with the group's environment: gloo over CUDA tensors on the one
    card, SCALE_BATCH / SCALE_RANKS images of the first batch, a warm-up
    update, one update unsharded, then the base sharded by JAX's rule and
    the same update; what it saw goes to ``<dir>/fsdp<r>.pt``."""
    from sam3_lora_tpu_torch.parallel import multihost

    if not multihost.initialize(backend="gloo"):
        raise SystemExit("fsdp rank: no process group in the environment")
    rank = multihost.process_index()
    try:
        cfg = fsdp_config()
        loader = DataLoader(SyntheticSamples(cfg, SCALE_BATCH, SEED), SCALE_BATCH // SCALE_RANKS,
                            shuffle=False, num_workers=2, host_shard=multihost.host_shard())
        trainer, batch = fsdp_trainer(cfg, loader, os.path.join(base, f"fsdp_out{rank}"))
        fsdp_update(trainer, batch)  # the warm-up
        plain = fsdp_update(trainer, batch)
        split, predicted = shard_base(trainer.model)
        sharded = fsdp_update(trainer, batch)
        torch.save({"plain": plain, "sharded": sharded, "split": split, "predicted": predicted},
                   os.path.join(base, f"fsdp{rank}.pt"))
    finally:
        multihost.shutdown()
    print(f"fsdp rank {rank}: done", flush=True)


def scale_out_fsdp(base: str, smi: str) -> list:
    """(f): the sharded frozen base in the int8 tier (module docstring,
    phase 18). Returns the failures."""
    from sam3_lora_tpu_torch.parallel import multihost

    cfg = fsdp_config()
    failed = []
    loader = DataLoader(SyntheticSamples(cfg, SCALE_BATCH, SEED), SCALE_BATCH, shuffle=False,
                        num_workers=2)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    try:
        if not multihost.initialize() or torch.distributed.get_backend() != "nccl":
            raise AssertionError("scale-out (f1): no NCCL group of 1")
        trainer, batch = fsdp_trainer(cfg, loader, os.path.join(base, "fsdp_one"))
        fsdp_update(trainer, batch)  # the warm-up
        plain = fsdp_update(trainer, batch)
        split, predicted = shard_base(trainer.model)
        sharded = fsdp_update(trainer, batch)
        del trainer, batch
    finally:
        multihost.shutdown()
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            os.environ.pop(var)
    torch.cuda.empty_cache()
    want = with_rope(train_step_launches(cfg))
    want = {**dict.fromkeys(plain["launches"], 0), **want}
    exact = same_update(plain, sharded)
    print(f"scale-out (f1): NCCL group of 1, int8 tier, batch {SCALE_BATCH}, {split} base leaves "
          f"placed by param_shardings(shard_base=True) over 1 rank: losses and gradients bit for "
          f"bit the unsharded update's {exact}; gathers {sharded['gathers']['forward']} in the "
          f"forward, {sharded['gathers']['backward']} in the backward; launches sharded "
          f"{ {k: v for k, v in sharded['launches'].items() if v} } (unsharded equal "
          f"{sharded['launches'] == plain['launches']}, the design's {plain['launches'] == want}); "
          f"host s {sharded['host_s']:.3f} vs {plain['host_s']:.3f}; peak "
          f"{sharded['peak'] / 2**30:.3f} vs {plain['peak'] / 2**30:.3f} GiB; {smi}", flush=True)
    if not exact:
        failed.append("(f1) the sharded update differs from the unsharded one")
    if not sharded["launches"] == plain["launches"] == want:
        failed.append(f"(f1) launches {sharded['launches']} vs unsharded {plain['launches']}, "
                      f"design {want}")
    if split != 365 or sharded["bytes"] != predicted or not sharded["gathers"]["backward"]:
        failed.append(f"(f1) {split} leaves split (want 365), {sharded['bytes']} B resident "
                      f"(rule {predicted}), gathers {sharded['gathers']}")

    t0 = time.perf_counter()
    ranks = run_ranks(base, "--fsdp-rank", "fsdp", "(f2)")
    wall = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(ranks[0]["sharded"]["grads"],
                                                 ranks[1]["sharded"]["grads"]))
    print(f"scale-out (f2): {SCALE_RANKS} gloo ranks on one card in {wall:.1f} s, "
          f"{SCALE_BATCH // SCALE_RANKS} images each, int8 tier; the reduced gradients equal "
          f"across ranks {same}; {smi}", flush=True)
    if not same:
        failed.append("(f2) the ranks' reduced gradients differ")
    for r, res in enumerate(ranks):
        p, s_ = res["plain"], res["sharded"]
        exact = same_update(p, s_)
        print(f"scale-out (f2) rank {r}: {res['split']} leaves split; reduced losses and "
              f"gradients bit for bit the unsharded ranks' {exact}; resident parameter bytes "
              f"{s_['bytes']} sharded, {res['predicted']} by the rule, {p['bytes']} unsharded; "
              f"max_memory_allocated {s_['peak']} B sharded vs {p['peak']} B unsharded "
              f"({(s_['peak'] - p['peak']) / 2**20:+.1f} MiB); step host s {s_['host_s']:.3f} "
              f"sharded vs {p['host_s']:.3f} unsharded; gathers {s_['gathers']}; {smi}",
              flush=True)
        if not exact:
            failed.append(f"(f2) rank {r}: the sharded update differs from the unsharded one")
        if s_["bytes"] != res["predicted"] or res["split"] != 365:
            failed.append(f"(f2) rank {r}: {s_['bytes']} B resident, the rule's {res['predicted']}"
                          f" ({res['split']} leaves split)")
        if not s_["peak"] < p["peak"]:
            failed.append(f"(f2) rank {r}: peak {s_['peak']} B not below unsharded {p['peak']} B")
    return failed


def phase_scale_out(g: torch.Generator, smi: str):
    """Data-parallel training, the frame-parallel detector, the base
    checkpoint and the logging utilities at the full config (module
    docstring, phase 18). Returns (a)'s launches with a group."""
    from sam3_lora_tpu_torch.parallel import multihost
    from sam3_lora_tpu_torch.utils import MemMeter, trace_span

    cfg = scale_out_config()
    failed = []
    with tempfile.TemporaryDirectory() as base:
        # (a) world size 1 under NCCL, in this process, against no group
        loader = DataLoader(SyntheticSamples(cfg, SCALE_BATCH * SCALE_STEPS, SEED), SCALE_BATCH,
                            shuffle=False, num_workers=2)
        plain, plain_snaps, plain_grads, _ = fit_recording(cfg, loader, os.path.join(base, "plain"))
        plain_stats = read_stats(os.path.join(base, "plain"))
        names = plain.trainable_names
        first = batch_to_device(next(iter(loader.epoch(0))), "cuda")
        # (e) a trace_span among one profiled step's events; MemMeter's peak
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with trace_span("scale_out.train_step"):
                Trainer.train_step(plain, first)
            torch.cuda.synchronize()
        span = [e for e in prof.key_averages() if e.key == "scale_out.train_step"]
        mem = MemMeter()
        mem.update()
        mem_equal = mem.peak == torch.cuda.max_memory_allocated()
        print(f"scale-out (e): trace_span 'scale_out.train_step' in the profiled step's events "
              f"{bool(span)} ({span[0].count if span else 0}x, {span[0].cpu_time_total / 1e3:.3f} "
              f"host ms)" if span else "scale-out (e): trace_span missing from the profile",
              flush=True)
        print(f"scale-out (e): MemMeter peak {mem.peak} B, torch.cuda.max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} B, equal {mem_equal}", flush=True)
        if not span:
            failed.append("(e) trace_span not among the profiler's events")
        if not mem_equal:
            failed.append("(e) MemMeter's peak differs from max_memory_allocated")
        del plain, first
        torch.cuda.empty_cache()

        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                          RANK="0", LOCAL_RANK="0")
        try:
            if not multihost.initialize() or torch.distributed.get_backend() != "nccl":
                raise AssertionError("scale-out (a): no NCCL group of 1")
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            group, group_snaps, _, result = fit_recording(cfg, loader, os.path.join(base, "group"))
            launches = counts()
            peak = torch.cuda.max_memory_allocated()
        finally:
            multihost.shutdown()
            for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
                os.environ.pop(var)
        group_stats = read_stats(os.path.join(base, "group"))
        del group
        torch.cuda.empty_cache()
        diff = snapshot_diff(names, plain_snaps, group_snaps)
        print(f"scale-out (a): NCCL group of 1 against no group, {SCALE_STEPS} updates of batch "
              f"{SCALE_BATCH}: step time (s) {[r['step_time_s'] for r in group_stats]} vs "
              f"{[r['step_time_s'] for r in plain_stats]} (first is the warm-up); losses "
              f"{[r['loss'] for r in group_stats]} vs {[r['loss'] for r in plain_stats]}; peak "
              f"{peak / 2**30:.3f} GiB; adapters bit for bit after every update: {not diff}; "
              f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
        if diff:
            worst = max(diff, key=lambda d: d[2])
            failed.append(f"(a) {len(diff)} adapter snapshots differ from the run without a "
                          f"group (first: update {diff[0][0]} {diff[0][1]}; worst: update "
                          f"{worst[0]} {worst[1]} by {worst[2]:.3e})")
        if [r["loss"] for r in group_stats] != [r["loss"] for r in plain_stats]:
            failed.append("(a) logged losses differ from the run without a group")
        want = {k: v * SCALE_STEPS for k, v in train_step_launches(cfg).items()}
        try:
            check_launches("scale-out (a)", launches, want)
        except AssertionError as e:
            failed.append(str(e))
        del plain_snaps, group_snaps

        # (b) two gloo ranks on the one card, each with half of the first batch
        split = split_reference(cfg, loader)
        t0 = time.perf_counter()
        ranks = run_ranks(base)
        wall = time.perf_counter() - t0
        rank_stats = read_stats(os.path.join(base, "out0"))
        errs = {n: ((ranks[0]["grads"][n] - plain_grads[n]).norm() / plain_grads[n].norm()).item()
                for n in names}
        worst = max(errs, key=errs.get)
        flat = [torch.cat([g[n].flatten() for n in names]) for g in (ranks[0]["grads"], plain_grads)]
        whole_err = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
        exact = all(torch.equal(ranks[0]["grads"][n], split["grads"][n]) for n in names)
        same = all(torch.equal(a, b) for a, b in zip(ranks[0]["adapters"], ranks[1]["adapters"]))
        loss_err = abs(rank_stats[0]["loss"] - plain_stats[0]["loss"]) / abs(plain_stats[0]["loss"])
        print(f"scale-out (b): {SCALE_RANKS} gloo ranks on one card in {wall:.1f} s, "
              f"{SCALE_BATCH // SCALE_RANKS} images each: reduced adapter gradients bit for bit "
              f"those of the same halves in this process {exact}; the halves' matching equal to "
              f"batch {SCALE_BATCH}'s {split['matching_equal']}, their scores within "
              f"{split['scores']:.3e}; against (a)'s batch {SCALE_BATCH} gradients: all adapters "
              f"as one rel err {whole_err:.3e} (bound {GRAD_RTOL}), by adapter max "
              f"{errs[worst]:.3e} ({worst}; bound {GRAD_RTOL_SPLIT}), median "
              f"{statistics.median(errs.values()):.3e}; adapters equal across ranks {same}; logged "
              f"loss (group mean) {rank_stats[0]['loss']:.5f} vs {plain_stats[0]['loss']:.5f} (rel "
              f"{loss_err:.3e}, bound {LOSS_RTOL}); rank 0 wrote {ranks[0]['written']}, rank 1 "
              f"{ranks[1]['written']}; peak {[round(r['peak'] / 2**30, 3) for r in ranks]} GiB",
              flush=True)
        if not exact:
            bad = max(names, key=lambda n: (ranks[0]["grads"][n] - split["grads"][n]).abs().max())
            failed.append(f"(b) the ranks' reduced gradients differ from the same halves' in one "
                          f"process (worst {bad})")
        if not split["matching_equal"]:
            failed.append("(b) the halves' matching differs from the batch's")
        if not (whole_err <= GRAD_RTOL and errs[worst] <= GRAD_RTOL_SPLIT):
            failed.append(f"(b) reduced gradients off: {whole_err:.3e} as one, "
                          f"{errs[worst]:.3e} at {worst}")
        if not same:
            failed.append("(b) the ranks' adapters differ")
        if not loss_err <= LOSS_RTOL:
            failed.append(f"(b) the logged loss is off by {loss_err:.3e}")
        if ranks[1]["written"] or "train_stats.json" not in ranks[0]["written"]:
            failed.append("(b) a rank other than 0 wrote files, or rank 0 wrote no stats")
        if any(r["steps"] != 1 for r in ranks):
            failed.append(f"(b) steps {[r['steps'] for r in ranks]}")

        # (c) the frame-parallel detector at world size 1
        frame_launches, frame_delta, frame_errs, det_s, loop_s = scale_out_frames(
            model_config(False), g)
        n_global = len(cfg.vit_global_blocks)
        n_chunks = SCALE_FRAMES // SCALE_CHUNK
        print(f"scale-out (c): FrameParallelDetector, {SCALE_FRAMES} frames of 1200x900 in "
              f"chunks of {SCALE_CHUNK}: host s a frame {det_s:.4f} against {loop_s:.4f} for "
              f"_forward frame by frame; max abs err against each frame alone {frame_errs} (bound "
              f"{SMALL_TOL}); launches { {k: v for k, v in frame_launches.items() if v} }",
              flush=True)
        if not all(v <= SMALL_TOL for v in frame_errs.values()):
            failed.append(f"(c) outputs off: {frame_errs}")
        try:
            check_launches("scale-out (c)", frame_launches, served(
                n_chunks, {"window_attention_rope_packed": cfg.vit_depth - n_global,
                           "long_attention_rope_packed": n_global},
                {"long_attention_packed": cfg.enc_layers}, frame_delta))
        except AssertionError as e:
            failed.append(str(e))

        # (d) the base checkpoint at the full config
        ck = scale_out_checkpoint(base)
        print(f"scale-out (d): save_base_checkpoint wrote {ck['arrays']} arrays, "
              f"{ck['bytes'] / 2**30:.3f} GiB, in {ck['save_s']:.2f} s; strict load "
              f"{ck['load_s']:.2f} s, parameters differing {len(ck['differ'])}; int8 engine from "
              f"the file bit for bit the one quantized directly: {ck['int8_equal']}", flush=True)
        if ck["differ"]:
            failed.append(f"(d) {len(ck['differ'])} parameters differ after the round trip "
                          f"(first {ck['differ'][:3]})")
        if not ck["int8_equal"]:
            failed.append("(d) the int8 engine built from the file differs")

        # (f) the sharded frozen base, in a group of 1 and in two gloo ranks
        failed += scale_out_fsdp(base, smi)
    print(f"scale-out: {smi}", flush=True)
    if failed:
        raise AssertionError("scale-out: " + "; ".join(failed))
    return launches


RESIZE_SHAPES = ((480, 640), (900, 1200), (1080, 1920))
RESIZE_MASKS = 8
RESIZE_REPS = 20


def pil_resize(image: np.ndarray, hw) -> np.ndarray:
    """PIL ``BILINEAR`` of a uint8 (H, W, 3) image or (H, W) mask to ``hw``:
    the JAX engine's host resize."""
    from PIL import Image

    return np.asarray(Image.fromarray(image).resize((hw[1], hw[0]), Image.BILINEAR))


def phase_resize(smi: str) -> None:
    """The serving path's resizes on the card against PIL's on the host:
    ``resize_pil_bilinear`` of three full-size images to 1008^2 byte for
    byte, ``preprocess_image`` equal to (PIL / 255 - 0.5) / 0.5 value for
    value, ``resize_masks_to`` of 288^2 masks to 900x1200 equal to the JAX
    engine's PIL mask resize; preprocess's median host s at 900x1200."""
    r = ModelConfig().img_size
    for hw in RESIZE_SHAPES:
        image = np.random.RandomState(sum(hw)).randint(0, 256, (*hw, 3)).astype(np.uint8)
        want = pil_resize(image, (r, r))
        got = resize_pil_bilinear(torch.from_numpy(image).cuda(), (r, r), dims=(0, 1))
        n_bad = int((got.cpu().numpy() != want).sum())
        x, out_hw = preprocess_image(image, r, "cuda")
        norm = ((want.astype(np.float32) / 255.0 - IMAGE_MEAN) / IMAGE_STD).transpose(2, 0, 1)[None]
        same = x.is_cuda and out_hw == hw and np.array_equal(x.cpu().numpy(), norm)
        print(f"resize: {hw[0]}x{hw[1]} -> {r}^2 on the card: {n_bad} of {want.size} values "
              f"differ from PIL's; preprocess equal to PIL's (x / 255 - 0.5) / 0.5: {same}",
              flush=True)
        if n_bad or not same:
            raise AssertionError(f"resize {hw}: {n_bad} values differ from PIL's, "
                                 f"normalized equal {same}")
    masks = np.random.RandomState(SEED).rand(RESIZE_MASKS, 288, 288) > 0.5
    want = np.stack([pil_resize((m * 255).astype(np.uint8), (900, 1200)) > 127.5 for m in masks])
    got = resize_masks_to(torch.from_numpy(masks).cuda(), (900, 1200)).cpu().numpy()
    n_bad = int((got != want).sum())
    print(f"resize: {RESIZE_MASKS} masks 288^2 -> 900x1200 on the card: {n_bad} of {want.size} "
          f"pixels differ from PIL's", flush=True)
    if n_bad:
        raise AssertionError(f"resize: {n_bad} mask pixels differ from PIL's")

    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    host_seconds(lambda: preprocess_image(image, r, "cuda"))  # the tap tables, once a shape
    card = [host_seconds(lambda: preprocess_image(image, r, "cuda"))[1]
            for _ in range(RESIZE_REPS)]
    pil = []
    for _ in range(RESIZE_REPS):
        t0 = time.perf_counter()
        (pil_resize(image, (r, r)).astype(np.float32) / 255.0 - IMAGE_MEAN) / IMAGE_STD
        pil.append(time.perf_counter() - t0)
    print(f"resize: preprocess 900x1200 -> {r}^2, host s to a device sync, median of "
          f"{RESIZE_REPS}: {statistics.median(card):.5f} on the card (uint8 to the card, the "
          f"two passes, the normalization), against {statistics.median(pil):.5f} for PIL and "
          f"the normalization on the host (the JAX engine's) | {smi}", flush=True)


def reference_state_dict(flat: dict, cfg: ModelConfig) -> dict:
    """The inverse of the checkpoint converter: the model's base as flat
    JAX-named, JAX-layout arrays (``base_params_to_jax``; the scanned ViT
    groups stacked when ``cfg`` scans them) -> a state dict under the
    reference SAM3 detector's names and layouts: the decoder's boxRPB MLPs
    out of ``rpb.``, ``kernel`` back to ``weight`` (a linear's (out, in), a
    conv's (out, in, kh, kw)), ``in_proj_weight`` (3d, d), the scanned
    groups as ``blocks.{i}``; and the tensors the converter skips (a
    block's RoPE table, the pixel decoder's unused third stage). The keys
    carry no ``detector.`` prefix: the converter's ``SKIP_PATTERNS`` and
    its scanned lookup (``_stack_scanned``) name the keys without it."""
    import re

    from sam3_lora_tpu_torch.cli.convert_checkpoint import RENAMES, vit_scan_map

    groups = vit_scan_map(cfg) if cfg.vit_scan_blocks else {}
    sd = {}
    for name, arr in flat.items():
        m = re.match(r"(.*trunk\.)(scan_blocks_\d+)\.block\.(.*)$", name)
        if m and m.group(2) in groups:
            items = [(f"{m.group(1)}blocks.{i}.{m.group(3)}", arr[j])
                     for j, i in enumerate(groups[m.group(2)])]
        else:
            items = [(name, arr)]
        for key, t in items:
            leaf = key.rsplit(".", 1)[-1]
            if leaf == "kernel":
                key = key[: -len("kernel")] + "weight"
                t = t.T if t.ndim == 2 else t.transpose(3, 2, 0, 1)
            elif leaf == "in_proj_weight":
                t = t.T
            for src, dst in RENAMES:
                if key.startswith(dst):
                    key = src + key[len(dst):]
            sd[key] = torch.from_numpy(np.ascontiguousarray(t))
    block = next(k for k in sd if ".trunk.blocks.0." in k).split(".trunk.blocks.0.")[0]
    sd[f"{block}.trunk.blocks.0.attn.freqs_cis"] = torch.zeros(4, 2)
    sd["segmentation_head.pixel_decoder.conv_layers.2.weight"] = torch.zeros(2, 2, 3, 3)
    sd["segmentation_head.pixel_decoder.norms.2.weight"] = torch.zeros(2)
    return sd


def phase_convert(smi: str) -> None:
    """The reference-checkpoint converter at the full config, bf16: a seeded
    model's base written as a reference-named fp32 ``.pt``, converted by
    ``cli/convert_checkpoint.py``'s main, served by ``SAM3LoRAInference(
    base_checkpoint=...)`` through K1-K3: one request's scores, boxes and
    masks bit for bit the source model's."""
    from sam3_lora_tpu_torch.cli import convert_checkpoint
    from sam3_lora_tpu_torch.utils.checkpoint import base_params_to_jax

    cfg = model_config(False)
    src = SAM3LoRAInference(cfg, None, seed=SEED + 2, device="cuda")
    sd = reference_state_dict(base_params_to_jax(src.model), cfg)
    n_ref = len(sd)
    with tempfile.TemporaryDirectory() as d:
        pt, npz = os.path.join(d, "sam3.pt"), os.path.join(d, "base.npz")
        t0 = time.perf_counter()
        torch.save(sd, pt)
        save_s = time.perf_counter() - t0
        del sd
        t0 = time.perf_counter()
        convert_checkpoint.main(["--torch-ckpt", pt, "--out", npz])
        convert_s = time.perf_counter() - t0
        pt_bytes, npz_bytes = os.path.getsize(pt), os.path.getsize(npz)
        os.remove(pt)
        t0 = time.perf_counter()
        engine = SAM3LoRAInference(cfg, None, base_checkpoint=npz, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    want = src.predict(image, PROMPTS[0], threshold=0.0)[0]
    reset_counts()
    got = engine.predict(image, PROMPTS[0], threshold=0.0)[0]
    check_launches("convert", counts(), served(1, set_image_launches(cfg), prompt_launches(cfg)))
    keys = ("scores", "boxes", "masks")
    equal = {k: bool(np.array_equal(got[k], want[k])) for k in keys}
    print(f"convert: {n_ref} reference tensors ({pt_bytes / 2**30:.3f} GiB .pt, written in "
          f"{save_s:.2f} s) -> {npz_bytes / 2**30:.3f} GiB .npz by cli.convert_checkpoint in "
          f"{convert_s:.2f} s, SAM3LoRAInference(base_checkpoint=...) on the card in "
          f"{load_s:.2f} s; one request ({got['num_detections']} detections at threshold 0, "
          f"K1-K3): bit for bit the source model's {equal} | {smi}", flush=True)
    if not all(equal.values()) or not got["num_detections"] == want["num_detections"] > 0:
        raise AssertionError(f"convert: outputs against the source model's {equal}")
    del src, engine
    torch.cuda.empty_cache()


MERGE_CONTROL_FACTOR = 4
# the adapters' own effect, max |bare base - adapted|, must be this many
# times the bf16 merge tolerance on every output: a merge that did nothing,
# or folded in a wrong scaling, then fails the tolerance
MERGE_SIGNAL_FACTOR = 4
# the merge phase's adapters: at the other phases' 0.02 they move the random
# model's scores by 1.3x the tolerance alone (an H100, 700 W); at 0.1 by
# 6.6x, while the merged forward's distance from the adapted one stays at
# the bf16 noise floor
MERGE_ADAPTER_STD = 0.1
RAW_OUTPUTS = ("scores", "presence", "boxes", "masks")


def max_diffs(a, b) -> dict:
    return {k: (x - y).abs().max().item() for k, x, y in zip(RAW_OUTPUTS, a, b)}


def bf16_rounding_control(model: torch.nn.Module, g: torch.Generator) -> None:
    """Move the base weight of every adapted layer by a random error of the
    size of one bf16 rounding (uniform in +-half a bf16 ulp of each value):
    the forward's sensitivity to the rounding that merging adds."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LoRALinear) and m.lora_a is not None:
                _, exp = torch.frexp(m.weight)
                ulp = torch.ldexp((m.weight != 0).to(m.weight.dtype), exp - 8)
                u = torch.rand(m.weight.shape, generator=g, device=m.weight.device)
                m.weight.add_((u - 0.5) * ulp)


def phase_merge(g: torch.Generator, smi: str) -> None:
    """merge_lora_into_base at the full config with live adapters (``lora_b``
    drawn at MERGE_ADAPTER_STD), by the recipe a user follows to serve a
    merged model in the int8 tier.

    bf16: one request's raw outputs from the bare base (adapters detached),
    adapted, and merged in place. The merged forward's largest difference
    from the adapted one is held to MERGE_CONTROL_FACTOR times a control's,
    the adapted forward with each adapted base weight moved by one bf16
    rounding's random error (merging rounds W + dW once where the adapted
    forward rounds W, the adapter's two products and its sum); the
    adapters' effect, bare base against adapted, must be MERGE_SIGNAL_FACTOR
    times that tolerance. The merged base is then saved
    (``save_base_checkpoint``).

    The int8 tier: an engine with the adapters (K5 on the ViT's qkv, fc1,
    fc2) against one that loads the merged base (``base_checkpoint=``) and
    quantizes it (K4 alone). The merged request's raw outputs are held to
    MERGE_CONTROL_FACTOR times the adapted int8 request's distance from the
    adapted bf16 one (one int8 quantization of the base; merging swaps
    that of W for that of W + dW). Each engine's launches as its first
    request captures its graphs, and a request's device ms."""
    from sam3_lora_tpu_torch.models.lora import merge_lora_into_base, save_lora_weights
    from sam3_lora_tpu_torch.utils.checkpoint import save_base_checkpoint

    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    cfg = model_config(False)
    engine = SAM3LoRAInference(cfg, LORA, seed=SEED, device="cuda")
    live_adapters(engine.model, g, MERGE_ADAPTER_STD)
    img, _ = preprocess_image(image, cfg.img_size, "cuda")
    ids = torch.from_numpy(np.asarray(engine.tokenizer(PROMPTS[0], context_length=cfg.
                                                       text_context_length), np.int64)).cuda()
    adapted = engine._forward(img, ids)
    layers = [m for m in engine.model.modules()
              if isinstance(m, LoRALinear) and m.lora_a is not None]
    saved = [(m.lora_a, m.lora_b, m.weight.clone()) for m in layers]
    for m in layers:
        m.lora_a = m.lora_b = None
    base = engine._forward(img, ids)
    for m, (a, b, _) in zip(layers, saved):
        m.lora_a, m.lora_b = a, b
    bf16_rounding_control(engine.model, torch.Generator(device="cuda").manual_seed(SEED))
    control = engine._forward(img, ids)
    with torch.no_grad():
        for m, (_, _, w) in zip(layers, saved):
            m.weight.copy_(w)
    del saved, layers
    with tempfile.TemporaryDirectory() as d:
        lora_path, base_path = os.path.join(d, "lora.npz"), os.path.join(d, "merged_base.npz")
        save_lora_weights(engine.model, lora_path)
        n = merge_lora_into_base(engine.model)
        merged = engine._forward(img, ids)
        diff, ctrl = max_diffs(merged, adapted), max_diffs(control, adapted)
        effect = max_diffs(base, adapted)
        tol = {k: MERGE_CONTROL_FACTOR * ctrl[k] for k in RAW_OUTPUTS}
        print(f"merge: bf16, {n} adapters merged; max |merged - adapted| {diff}; tolerance "
              f"{MERGE_CONTROL_FACTOR} x the one-rounding control's {ctrl}; the adapters' "
              f"effect max |bare base - adapted| {effect} (at least {MERGE_SIGNAL_FACTOR} x "
              f"the tolerance)", flush=True)
        bad = [k for k in RAW_OUTPUTS if not diff[k] <= tol[k]]
        if bad or not all(torch.isfinite(t).all() for t in merged):
            raise AssertionError(f"merge: {bad} past {MERGE_CONTROL_FACTOR} x the control")
        weak = [k for k in RAW_OUTPUTS if not effect[k] >= MERGE_SIGNAL_FACTOR * tol[k]]
        if weak:
            raise AssertionError(f"merge: the adapters move {weak} by less than "
                                 f"{MERGE_SIGNAL_FACTOR} x the tolerance")
        save_base_checkpoint(engine.model, base_path)
        del engine, base, control, merged
        torch.cuda.empty_cache()

        gemm_int8.GEMM_LORA_FUSED = True
        cfg8 = model_config(True)
        engines = {"adapted": SAM3LoRAInference(cfg8, LORA, seed=SEED, weights=lora_path,
                                                device="cuda"),
                   "merged": SAM3LoRAInference(cfg8, None, base_checkpoint=base_path,
                                               device="cuda")}
    raw8, launches = {}, {}
    for tag, e in engines.items():  # each engine's first request: it captures its graphs
        reset_counts()
        raw8[tag] = e._forward(img, ids)
        launches[tag] = ({k: v for k, v in counts().items() if v}, graph_delta())
    diff8, ctrl8 = max_diffs(raw8["merged"], raw8["adapted"]), max_diffs(raw8["adapted"], adapted)
    print(f"merge: int8 tier, max |merged - adapted| {diff8}; tolerance "
          f"{MERGE_CONTROL_FACTOR} x the adapted int8 request's distance from bf16 {ctrl8}",
          flush=True)
    bad = [k for k in RAW_OUTPUTS if not diff8[k] <= MERGE_CONTROL_FACTOR * ctrl8[k]]
    if bad or not all(torch.isfinite(t).all() for t in raw8["merged"]):
        raise AssertionError(f"merge: int8 {bad} past {MERGE_CONTROL_FACTOR} x the control")
    del raw8, adapted
    for tag, engine in engines.items():
        engine.predict(image, PROMPTS[0])  # first call: set-up
        prof = profile_step(lambda: engine.predict(image, PROMPTS[0]))
        print(f"merge: int8 tier, {tag} request: {prof['device_ms']:.3f} device ms "
              f"(torch.profiler), launches of its capture {launches[tag][0]} | {smi}", flush=True)
    backbone = set_image_launches(cfg8)
    merged = {**backbone, "int8_lora_gemm_wres": 0,
              "int8_gemm_wres": backbone["int8_gemm_wres"] + backbone["int8_lora_gemm_wres"]}
    for tag, design in (("adapted", backbone), ("merged", merged)):
        got, delta = launches[tag]
        check_launches(f"merge {tag}", {**dict.fromkeys(counts(), 0), **got},
                       served(1, design, prompt_launches(cfg8), delta))
    del engines, engine
    torch.cuda.empty_cache()
    gemm_int8.GEMM_LORA_FUSED = False


def small_models(int8: bool = False, **overrides):
    """A config small enough for the CPU, with the heads of the full model
    (ViT 2 x 64, encoder 4 x 32) so the kernels sit on the path: fp32 on the
    CPU and bf16 on the card, same weights, live adapters. With ``int8`` its
    ViT GEMMs alone are in the int8 tier, as in the full config
    (base_quant_min_dim at the ViT width; d_model 64, 2 heads x 32, keeps the
    geometry encoder's 66-wide projection under the gate), the base quantized
    on each side from the same fp32 weights. ``overrides`` go to both sides'
    configs, but ``param_dtype`` (the storage of the frozen base) to the
    card's alone."""
    widths = dict(vit_dim=128, vit_heads=2, d_model=128, enc_heads=4)
    if int8:
        widths.update(d_model=64, enc_heads=2, base_quant="int8", base_quant_min_dim=128)
    param_dtype = overrides.pop("param_dtype", "float32")
    cfg = tiny_model_config(flash_attention_min_seq=16, **{**widths, **overrides})
    lora = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "linear1"))
    cpu = build_sam3_image_model(cfg, lora=lora, device="cpu")
    init_model(cpu, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, LoRALinear) and m.lora_b is not None:
                m.lora_b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(SEED + 1))
    gpu = build_sam3_image_model(cfg.replace(dtype="bfloat16", param_dtype=param_dtype),
                                 lora=lora, device="cuda")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    if cfg.base_quant != "none":
        for model in (cpu, gpu):
            if not quant.prequantize_model(model, cfg.base_quant_min_dim):
                raise AssertionError("the small int8 config quantized no layer")
    return cfg, cpu, gpu


def small_batch(cfg, with_targets: bool):
    from sam3_lora_tpu_torch.models.tokenizer import get_default_tokenizer
    from sam3_lora_tpu_torch.train.data import collate

    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.standard_normal((1, 3, cfg.img_size, cfg.img_size)).astype(np.float32))
    if not with_targets:
        ids = torch.from_numpy(np.asarray(get_default_tokenizer()(
            ["crack", "wall"], context_length=cfg.text_context_length), np.int64))
        return Batch(images, ids, torch.zeros((2,), dtype=torch.long))
    ds = SyntheticSamples(cfg, 2, SEED)
    return collate([ds.load(i) for i in range(2)], cfg=cfg)


def small_train_step(model, batch):
    """(loss, matching, adapter gradients) of one training step."""
    named = trainable_parameters(model)
    model.zero_grad(set_to_none=True)
    model.train()
    model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0  # the CPU and card RNGs differ
    out = model(batch)
    loss = compute_losses(out, batch.targets)["core_loss"]
    loss.backward()
    return loss.item(), out["indices"].cpu(), {n: p.grad.float().cpu() for n, p in named}


def compare_step(tag: str, ref, got, grad_rtol: float) -> None:
    (ref_loss, ref_idx, ref_g), (loss, idx, grads) = ref, got
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    grad_errs = {n: ((grads[n] - ref_g[n]).norm() / ref_g[n].norm()).item() for n in ref_g}
    worst = max(grad_errs, key=grad_errs.get)
    print(f"{tag} train step: loss {loss:.5f} vs CPU fp32 {ref_loss:.5f} (rel {loss_err:.3e}, "
          f"bound {LOSS_RTOL}); matching equal {torch.equal(idx, ref_idx)}; adapter grads "
          f"rel err max {grad_errs[worst]:.3e} ({worst}), median "
          f"{statistics.median(grad_errs.values()):.3e} (bound {grad_rtol})", flush=True)
    if not torch.equal(idx, ref_idx):
        raise AssertionError(f"{tag}: the card's matching differs from the CPU's")
    if not loss_err <= LOSS_RTOL or not grad_errs[worst] <= grad_rtol:
        raise AssertionError(f"{tag} training step disagrees: loss {loss_err:.3e}, "
                             f"grad {grad_errs[worst]:.3e}")


BENCH_SMALL = dict(param_dtype="bfloat16", vit_remat_policy="wo_block_mid", enc_remat=False,
                   enc_remat_ffn=True, dec_remat=True)


def phase_small_reference(tag: str = "small", int8: bool = False, routes: bool = False,
                          **overrides):
    """The small config's eval forward and one training step, the card
    against the CPU; with ``int8`` its ViT in the int8 tier (bounds above);
    ``overrides`` (BENCH_SMALL) change both configs. With ``routes``, one
    training step on the card per window route against the same CPU step;
    returns each route entry's backward launches."""
    grad_rtol = GRAD_RTOL_INT8 if int8 else GRAD_RTOL
    cfg, cpu, gpu = small_models(int8, **overrides)
    images_batch = small_batch(cfg, with_targets=False)
    with torch.no_grad():
        ref = cpu(images_batch)
        out = gpu(batch_to_device(images_batch, "cuda"))
    errs = {
        "boxes": (out["pred_boxes"].float().cpu() - ref["pred_boxes"]).abs().max().item(),
        "scores": (torch.sigmoid(out["pred_logits"].float().cpu())
                   - torch.sigmoid(ref["pred_logits"])).abs().max().item(),
        "masks": (torch.sigmoid(out["pred_masks"].float().cpu())
                  - torch.sigmoid(ref["pred_masks"])).abs().max().item(),
    }
    print(f"{tag} reference: max abs err vs CPU fp32 {errs} (bound {SMALL_TOL})", flush=True)
    bad = {k: v for k, v in errs.items() if not v <= SMALL_TOL}
    if bad:
        raise AssertionError(f"{tag} config disagrees with the CPU reference: {bad}")

    # one training step: loss, matching and every adapter gradient
    batch = small_batch(cfg, with_targets=True)
    ref_step = small_train_step(cpu, batch)
    gpu_batch = batch_to_device(batch, "cuda")
    if not routes:
        compare_step(tag, ref_step, small_train_step(gpu, gpu_batch), grad_rtol)
        return {}
    bwd = {}
    for route, packed, fuse_rope, qkv_native, entry in (ROUTES if cfg.vit_use_rope
                                                        else ROUTES_NO_ROPE):
        set_route(packed, fuse_rope, qkv_native)
        reset_counts()
        got = small_train_step(gpu, gpu_batch)
        torch.cuda.synchronize()
        if not entry.launches or not entry.bwd_launches:
            raise AssertionError(f"{tag} {route}: {entry.__name__} ran {entry.launches} forward, "
                                 f"{entry.bwd_launches} backward")
        name = entry.__name__ + "_bwd"
        bwd[name] = bwd.get(name, 0) + entry.bwd_launches
        compare_step(f"{tag} {route} ({entry.__name__})", ref_step, got, grad_rtol)
    set_route(True, True, False)
    return bwd


PROBES = (window_cost, dma_floor, packed)
PROBE_REPS = 20
PROBE_ROW_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                  "plain_ms", "bound_ms", "bound_by", "library_ms", "library", "binding",
                  "passes", "full_paired_ms", "attention_cuda_ms")
PROBE_BOUND_SLACK = 1.05  # bound/time above this: the kernel skipped work it claims
PROBE_FULL_SPREAD = 0.10  # the full rung's time against attention_cuda's, timed in turns


def phase_probes(g: torch.Generator):
    """The window-kernel probes at batch 8, their main path (``rows``) with
    the counts set to 0 before; each row holds its timed output against its
    plain version's on the same operands and counts its own launches. Then
    the script's check of the pair forms, whose launches count nowhere.
    Returns the kernel rows."""
    t0 = time.perf_counter()
    probe_kernels.reset_counts()
    rows = [r for m in PROBES for r in m.rows(g, BENCH_BATCH, PROBE_REPS, "cuda")]
    torch.cuda.synchronize()
    sass = window_cost.op_sass(_cuda.build())
    failed = []
    for r in rows:
        print(f"probes {format_row(r)}", flush=True)
        if r.get("binding"):
            op, mix = r["variant"], r["mix"]
            print(f"probes op {op}: per lane and row pass, mix {mix} | SASS "
                  f"{ {u: round(n, 3) for u, n in sass[op].items() if n} } | binds {r['binding']}: "
                  f"share {r['bound_ms'] / r['ms']:.3f} | one-row bound {r['old_bound_ms']:.4f} ms "
                  f"(share {r['old_bound_ms'] / r['ms']:.3f}) | {r['layout']}", flush=True)
            failed += [f"{r['name']} SASS {b}" for b in window_cost.sass_check(op, sass[op])]
            if "moving_check" in r:  # a tile the op changes, bit for bit against op_plain
                print(f"probes {format_check(r['name'] + ' (moving)', r['moving_check'])}",
                      flush=True)
                if not r["moving_check"][2]:
                    failed.append(f"{r['name']}: differs from op_plain on a tile it changes")
        if not r["ok"]:
            failed.append(f"{r['name']}: max abs err {r['max_abs_err']:.3e} over {r['limit']:.3e}")
        if r["bound_ms"] / r["ms"] > PROBE_BOUND_SLACK:
            failed.append(f"{r['name']}: {r['ms']:.4f} ms under its bound {r['bound_ms']:.4f} ms")
        if "attention_cuda_ms" in r:
            if not r["equals_attention_cuda"]:
                failed.append(f"{r['name']}: output differs from attention_cuda's")
            if abs(r["full_paired_ms"] / r["attention_cuda_ms"] - 1) > PROBE_FULL_SPREAD:
                failed.append(f"{r['name']}: {r['full_paired_ms']:.4f} ms against "
                              f"attention_cuda's {r['attention_cuda_ms']:.4f} ms, timed in turns")
    for name, c in packed.check(g).items():
        print(f"probes {format_check(name, c)}", flush=True)
        if not c[2]:
            failed.append(f"{name}: max abs err {c[0]:.3e} over {c[1]:.3e}")
    print(f"probes: {len(rows)} rows in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise AssertionError("; ".join(failed))
    torch.cuda.empty_cache()
    return [{k: r[k] for k in PROBE_ROW_KEYS if k in r} for r in rows]


def main():
    import sys

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    if sys.argv[1:2] == ["--scale-out-rank"]:  # one rank of the scale-out phase's (b)
        return scale_out_rank(sys.argv[2])
    if sys.argv[1:2] == ["--fsdp-rank"]:  # one rank of the scale-out phase's (f2)
        return fsdp_rank(sys.argv[2])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = _cuda.build()
    print(f"build: {lib} in {time.perf_counter() - t0:.2f} s", flush=True)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = phase_kernels(g, n_prompts=len(PROMPTS[-1]))
    serve, lat, serve_peak = phase_slice(g)
    serve8, lat8, serve_peak8 = phase_slice(g, int8=True)
    train, steps, train_peak = phase_train(g)
    train8, steps8, train_peak8 = phase_train(g, int8=True)
    print(f"int8 tier against bf16 (this call): serving latency (s) {[round(t, 4) for t in lat8]} "
          f"vs {[round(t, 4) for t in lat]}, peak {serve_peak8 / 2**30:.3f} vs "
          f"{serve_peak / 2**30:.3f} GiB; training step (s) {steps8[1:]} vs {steps[1:]} after "
          f"warm-up, peak {train_peak8 / 2**30:.3f} vs {train_peak / 2**30:.3f} GiB", flush=True)
    bench, _, _ = phase_bench_train(g)
    routes = phase_routes(g)
    phase_processor(g)
    phase_processor(g, int8=True)
    phase_validate(g)
    proc = phase_interactive(g)
    phase_agent(proc, smi)
    del proc
    torch.cuda.empty_cache()
    phase_model_options(g)
    # its own generator: the later phases draw what they drew before it, and
    # the phase alone draws what it draws here
    phase_video(torch.Generator(device="cuda").manual_seed(SEED), smi)
    phase_video_train(torch.Generator(device="cuda").manual_seed(SEED), smi)
    phase_int8_bwd(g)
    # its own generator, as the video phase
    phase_scale_out(torch.Generator(device="cuda").manual_seed(SEED), smi)
    phase_resize(smi)
    phase_convert(smi)
    phase_merge(torch.Generator(device="cuda").manual_seed(SEED), smi)  # its own, as video's
    phase_small_reference()
    phase_small_reference("small-int8", int8=True)
    phase_small_reference("small-bench", int8=True, **BENCH_SMALL)
    phase_small_reference("small-bench-int8_bwd", int8=True, **{**BENCH_SMALL, "base_quant": "int8_bwd"})
    route_bwd = collections.Counter(phase_small_reference("small-routes", routes=True))
    route_bwd.update(phase_small_reference("small-routes-no-rope", routes=True, vit_use_rope=False))
    route_names = {e.__name__ for e in WINDOW_ROUTES}
    for row in rows:
        name = row["name"]
        base = name[:-len("_bwd")] if name.endswith("_bwd") else name
        if base in route_names:
            # forward: the full-width request of its route; backward: the
            # small config's training step of its route; W-p with RoPE: its
            # dot_product_attention call, forward and back
            row["launches"] = routes.get(name, 0) + route_bwd.get(name, 0)
        elif name == "attention_rope":
            row["launches"] = serve[name]
        elif name in ("int8_gemm_wres", "int8_lora_gemm_wres"):
            row["launches"] = serve8[name] + train8[name] + bench[name]
        elif name == "bf16_gemm_wres_nt":
            row["launches"] = train8[name]
        else:
            row["launches"] = (train[name] + bench[name]) if name.endswith("_bwd") else serve[name]
    rows += phase_probes(g)
    idle = [row["name"] for row in rows if not row["launches"]]
    if idle:
        raise AssertionError(f"kernels no path launched: {idle}")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
