"""Configuration of the port: its own copy of the JAX package's dataclasses.

``ModelConfig`` (the SAM3 image-model architecture; defaults reproduce the
released 848M model), ``LoRAConfig`` (the LoRA YAML surface: rank, alpha,
dropout, target modules, six component flags), ``TrainConfig`` (the
``training:`` and ``output:`` YAML sections), ``tiny_model_config`` and
``load_yaml_config``: the same fields, defaults and methods as
``sam3_lora_tpu/config.py``, so a config means the same model in both
packages (``tests/test_torch_config.py`` holds them equal). The port imports
nothing of the JAX package; code of the port, and scripts that drive it,
import these names from here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """SAM3 image model architecture. Defaults == facebook/sam3 release.

    Citations point at the reference lines that fix each value.
    """

    # --- ViT backbone (model_builder.py:69-96) ---
    img_size: int = 1008
    patch_size: int = 14
    vit_dim: int = 1024
    vit_depth: int = 32
    vit_heads: int = 16
    vit_mlp_ratio: float = 4.625
    vit_window_size: int = 24
    vit_global_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    vit_drop_path_rate: float = 0.1
    vit_pretrain_img_size: int = 336  # abs-pos table is (336/14)^2 = 24x24 (+cls)
    vit_use_abs_pos: bool = True
    vit_tile_abs_pos: bool = True     # tile, don't interpolate (vitdet.py:207-219)
    vit_use_rope: bool = True
    vit_rope_interp: bool = True      # scale rope positions by pt/size (vitdet.py:439-441)
    vit_rope_theta: float = 10000.0
    vit_ln_pre: bool = True
    # the JAX ViT scans its windowed-block runs; here it names the layout of
    # the checkpoints and adapter files (scan_blocks_{g}.block.*)
    vit_scan_blocks: bool = True
    # rematerialization of ViT blocks in training: "windows_only" (the port's
    # policy) replays the windowed blocks in the backward and runs the global
    # blocks once; "full", "block_mid" and "wo_block_mid" are the JAX
    # package's other policies
    vit_remat_policy: str = "windows_only"
    # rematerialize the fusion-encoder layers (or only their FFN) and the
    # decoder layers in training
    enc_remat: bool = True
    enc_remat_ffn: bool = False
    dec_remat: bool = False
    # decoder boxRPB cross-attn: chunked separable-bias path (never builds the
    # dense (B,H,Q,HW) bias/logits; ops/rpb_attention.py). False = dense oracle.
    dec_separable_bias: bool = True

    # --- FPN neck (model_builder.py:99-107, necks.py:13-99) ---
    d_model: int = 256
    neck_scale_factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    scalp: int = 1                    # drop lowest-res level (vl_combiner.py:89-94)

    # --- Text encoder (model_builder.py:486-495, text_encoder_ve.py:253-284) ---
    text_width: int = 1024
    text_layers: int = 24
    text_heads: int = 16
    text_context_length: int = 32
    text_vocab_size: int = 49408
    text_proj_dim: int = 512          # dead-weight CLIP projection kept for ckpt parity

    # --- Fusion (DETR) encoder (model_builder.py:115-150) ---
    enc_layers: int = 6
    enc_heads: int = 8
    enc_ffn_dim: int = 2048
    enc_dropout: float = 0.1

    # --- DETR decoder (model_builder.py:153-187) ---
    dec_layers: int = 6
    dec_heads: int = 8
    dec_ffn_dim: int = 2048
    dec_dropout: float = 0.1
    num_queries: int = 200
    dac: bool = True                  # DAC-DETR query doubling in training
    box_rpb: str = "log"              # boxRPB bias flavour: none|log|linear|both
    presence_token: bool = True
    o2m_topk: int = 4                 # DAC o2m matcher top-k (native trainer)

    # --- Geometry encoder (model_builder.py:232-285) ---
    geo_layers: int = 3
    geo_roi_size: int = 7
    # mask-prompt path (FusedMaskEncoder, geometry_encoders.py:436-478).
    # OFF by default: the released facebook/sam3 image model builds its
    # SequenceGeometryEncoder with mask_encoder=None (model_builder.py:269-
    # 284), so no release checkpoint tensors exist for this path.
    geo_mask_prompts: bool = False
    geo_mask_fuser_layers: int = 2

    # --- Segmentation head (model_builder.py:204-229) ---
    seg_upsampling_stages: int = 3

    # --- Scoring (model_builder.py:190-201, model_misc.py:37-91) ---
    score_mlp_hidden: int = 2048
    score_clamp: float = 12.0
    presence_clamp: float = 10.0

    # --- static padding (replaces dynamic pad-to-longest) ---
    max_prompt_boxes: int = 1         # geometric-prompt box slots per query
    max_targets: int = 32             # GT objects per query (loss/matcher padding)
    # GT-mask resolution for the mask loss. The reference upsamples 288^2
    # predictions to full image res (1008^2) before focal+dice
    # (loss_fns.py:684-696); computing at the prediction's native 288^2 with
    # area-downsampled GT is 12x cheaper and numerically near-identical.
    # Set to img_size for exact reference parity.
    mask_loss_resolution: int = 288

    # --- numerics ---
    dtype: str = "float32"            # compute dtype ("bfloat16" on the card)
    param_dtype: str = "float32"
    # self-attention of at least flash_attention_min_seq tokens on both sides
    # (the 5184-token global ViT blocks and the fusion encoder) takes the
    # packed long-attention entry points; shorter runs the plain path
    use_flash_attention: bool = True
    flash_attention_min_seq: int = 2048
    # Frozen-base GEMM quantization tier (ops/quant.py):
    #   "none"     — GEMMs in the compute dtype
    #   "int8"     — forward GEMMs W8A8 (int8 weights and per-row dynamic
    #                int8 activations); backward dx against dequant(W)
    #   "int8_bwd" — dx GEMMs also int8 (not ported; the JAX package has it)
    # Applies to LoRALinear GEMMs with min(in, out) >= base_quant_min_dim —
    # by default the 1024-wide ViT trunk + text encoder, not the 256-wide
    # detection heads.
    base_quant: str = "none"
    base_quant_min_dim: int = 512

    @property
    def feat_size(self) -> int:
        return self.img_size // self.patch_size  # 72

    @property
    def vit_mlp_hidden(self) -> int:
        return int(self.vit_dim * self.vit_mlp_ratio)  # 4736

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def tiny_model_config(**overrides) -> ModelConfig:
    """A miniature config for tests: same topology, ~1000x fewer FLOPs."""
    base = dict(
        img_size=56,
        patch_size=14,          # feat 4x4
        vit_dim=32,
        vit_depth=4,
        vit_heads=2,
        vit_mlp_ratio=4.0,
        vit_window_size=2,
        vit_global_blocks=(1, 3),
        vit_pretrain_img_size=28,  # 2x2 abs-pos tiled to 4x4
        vit_drop_path_rate=0.0,
        d_model=32,
        text_width=32,
        text_layers=2,
        text_heads=2,
        text_context_length=8,
        text_vocab_size=49408,
        text_proj_dim=16,
        enc_layers=2,
        enc_heads=2,
        enc_ffn_dim=64,
        enc_dropout=0.0,
        dec_layers=2,
        dec_heads=2,
        dec_ffn_dim=64,
        dec_dropout=0.0,
        num_queries=12,
        geo_layers=1,
        score_mlp_hidden=64,
        mask_loss_resolution=16,  # tiny pixel-decoder output res
        max_targets=5,
        max_prompt_boxes=2,
    )
    base.update(overrides)
    return ModelConfig(**base)


# ---------------------------------------------------------------------------
# LoRA config (parity with reference lora_layers.py:94-155)
# ---------------------------------------------------------------------------

DEFAULT_TARGET_MODULES = ("q_proj", "k_proj", "v_proj", "out_proj")


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.0
    target_modules: Tuple[str, ...] = DEFAULT_TARGET_MODULES
    apply_to_vision_encoder: bool = True
    apply_to_text_encoder: bool = True
    apply_to_geometry_encoder: bool = False
    apply_to_detr_encoder: bool = True
    apply_to_detr_decoder: bool = True
    apply_to_mask_decoder: bool = False

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def should_apply(self, module_name: str) -> bool:
        """Reference name-matching semantics (lora_layers.py:174-198).

        ``module_name`` is a dot-separated torch-style module path. Component gating
        is by substring; the final path component must be in ``target_modules``;
        ``out_proj`` is always skipped (the reference skips it because
        nn.MultiheadAttention accesses ``.weight`` directly; we keep the behaviour
        for config parity).
        """
        n = module_name
        if ("vision_encoder" in n or "vision_backbone" in n) and not self.apply_to_vision_encoder:
            return False
        if ("text_encoder" in n or "language_backbone" in n) and not self.apply_to_text_encoder:
            return False
        if "geometry_encoder" in n and not self.apply_to_geometry_encoder:
            return False
        if ("detr_encoder" in n or "transformer.encoder" in n) and not self.apply_to_detr_encoder:
            return False
        if ("detr_decoder" in n or "transformer.decoder" in n) and not self.apply_to_detr_decoder:
            return False
        if "mask_decoder" in n and not self.apply_to_mask_decoder:
            return False
        basename = n.split(".")[-1]
        if basename == "out_proj":
            return False
        return basename in self.target_modules

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LoRAConfig":
        kw = dict(d)
        if "target_modules" in kw and kw["target_modules"] is not None:
            kw["target_modules"] = tuple(kw["target_modules"])
        known = {f.name for f in dataclasses.fields(LoRAConfig)}
        kw = {k: v for k, v in kw.items() if k in known}
        return LoRAConfig(**kw)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["target_modules"] = list(d["target_modules"])
        return d


# ---------------------------------------------------------------------------
# Training config (YAML `training:` + `output:` sections)
# ---------------------------------------------------------------------------


@dataclass
class TrainConfig:
    data_dir: str = "data"
    batch_size: int = 4
    num_workers: int = 2
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    num_epochs: int = 100
    warmup_steps: int = 200
    lr_scheduler: str = "cosine"
    logging_steps: int = 10
    eval_steps: int = 100
    save_steps: int = 100
    mixed_precision: str = "bf16"
    seed: int = 42
    gradient_accumulation_steps: int = 1
    output_dir: str = "outputs/sam3_lora"
    save_lora_only: bool = True
    # COCO_FROM_JSON query generation (coco_json_loaders.py:102-280): one
    # query per (image, category) instead of one per image; with negatives,
    # absent categories become empty-target "concept absent" queries.
    per_category_queries: bool = False
    include_negatives: bool = False
    # Batches whose host->device transfer is started ahead of the step that
    # consumes them (train/prefetch.py) — the reference's pin_memory +
    # non_blocking copy overlap (train_sam3_lora_native.py:823-843). 0
    # disables (synchronous shard_batch placement per step).
    device_prefetch: int = 2

    @staticmethod
    def from_yaml_dict(cfg: Dict[str, Any]) -> "TrainConfig":
        t = dict(cfg.get("training", {}))
        o = dict(cfg.get("output", {}))
        known = {f.name for f in dataclasses.fields(TrainConfig)}
        merged = {**t, **o}
        merged = {k: v for k, v in merged.items() if k in known}
        # YAML often stores floats as strings ("5e-5")
        for k in ("learning_rate", "weight_decay", "adam_epsilon", "max_grad_norm"):
            if k in merged:
                merged[k] = float(merged[k])
        return TrainConfig(**merged)


def load_yaml_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)
