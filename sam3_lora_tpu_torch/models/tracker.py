"""Tracker components (port of ``sam3_lora_tpu/models/tracker.py``): the
memory encoder, the memory attention and ``TrackerCore``, one per-frame
step of the video tracker, whose SAM heads also serve the interactive image
predictor.

* ``SimpleMaskDownSampler``: a mask, resized to 16x the feature grid, down
  to the grid by 4x (conv k3 s2 p1, LayerNorm2d, GELU) with channels
  1 -> 4 -> 16 -> 64 -> 256, then a 1x1 conv to ``embed_dim``;
* ``CXBlock``: a ConvNeXt block (7x7 depthwise conv, LayerNorm2d, pointwise
  linears, layer scale); ``SimpleMaskEncoder`` fuses mask and pixel
  features through them and emits the sine PE;
* ``RoPEAttention``: single-head attention with 2D axial RoPE on
  interleaved channel pairs (``ops/rope.py::apply_rope``, not the ViT's
  rotate-half), k's tables repeated over memory frames, and the trailing
  object-pointer tokens left unrotated;
* ``MemoryAttention``: 4 pre-norm layers (self RoPE attention, cross RoPE
  attention into the 64-wide memory, FFN), the input plus 0.1 x its PE.

The memory bank has a static shape: memory slots then pointer slots, with a
True = pad mask. Module and parameter names are the JAX package's, so a JAX
``TrackerCore`` param tree loads strictly through the weight bridge
(``utils/checkpoint.py::load_jax_tree``). The attention is the plain
``dot_product_attention``: the JAX tracker runs no Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention, merge_heads, split_heads
from ..ops.interpolate import resize_bilinear
from ..ops.posenc import get_1d_sine_pe, sine_pos_grid
from ..ops.rope import apply_rope, compute_axial_freqs, rope_cos_sin
from .layers import MLP, Conv2d, Dropout, LayerNorm, LoRALinear, Spec, trunc_normal_
from .sam_heads import LayerNorm2d, MaskDecoder, PromptEncoder


class SimpleMaskDownSampler(nn.Module):
    """Total stride 16 in 4 layers of conv k3 s2 p1 (the torch Sequential's
    conv, norm and activation slots: indices 0, 1, 3, 4, ...)."""

    def __init__(self, spec: Spec, embed_dim: int):
        super().__init__()
        layers: Dict[str, nn.Module] = {}
        ch, idx = 1, 0
        for _ in range(4):
            out_ch = ch * 4
            layers[str(idx)] = Conv2d(ch, out_ch, (3, 3), spec, stride=2, padding=1)
            layers[str(idx + 1)] = LayerNorm2d(out_ch, spec)
            ch, idx = out_ch, idx + 3
        layers[str(idx)] = Conv2d(ch, embed_dim, (1, 1), spec)
        self.encoder = nn.ModuleDict(layers)

    def forward(self, x: torch.Tensor, interpol_size: Tuple[int, int]) -> torch.Tensor:
        if tuple(x.shape[-2:]) != tuple(interpol_size):
            x = resize_bilinear(x.float(), interpol_size)
        mods = list(self.encoder.values())
        for conv, norm in zip(mods[0:-1:2], mods[1:-1:2]):
            x = F.gelu(norm(conv(x)))
        return mods[-1](x)


class CXBlock(nn.Module):
    LAYER_SCALE_INIT = 1e-6

    def __init__(self, spec: Spec, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, (7, 7), spec, padding=3, groups=dim)
        self.norm = LayerNorm2d(dim, spec)
        self.pwconv1 = LoRALinear(dim, 4 * dim, spec)
        self.pwconv2 = LoRALinear(4 * dim, dim, spec)
        self.gamma = spec.empty(dim, dtype=torch.float32)

    def init_parameters(self, g: torch.Generator) -> None:
        nn.init.constant_(self.gamma, self.LAYER_SCALE_INIT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.dwconv(x)).permute(0, 2, 3, 1)  # NCHW -> NHWC
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        y = y * self.gamma.to(y.dtype)
        return x + y.permute(0, 3, 1, 2)


class SimpleMaskEncoder(nn.Module):
    """Downsample the mask, fuse it with the pixel features, project to the
    memory width, emit the sine PE."""

    def __init__(self, spec: Spec, out_dim: int, in_dim: int, num_fuser_layers: int = 2):
        super().__init__()
        self.mask_downsampler = SimpleMaskDownSampler(spec, in_dim)
        self.pix_feat_proj = Conv2d(in_dim, in_dim, (1, 1), spec)
        self.fuser = nn.ModuleDict({"layers": nn.ModuleList(
            CXBlock(spec, in_dim) for _ in range(num_fuser_layers))})
        self.out_dim = out_dim
        self.out_proj = Conv2d(in_dim, out_dim, (1, 1), spec) if out_dim != in_dim else None

    def forward(self, pix_feat: torch.Tensor, masks: torch.Tensor,
                skip_mask_sigmoid: bool = False) -> Dict[str, torch.Tensor]:
        """pix_feat (B, in_dim, H, W), masks (B, 1, Hm, Wm) logits."""
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        h, w = pix_feat.shape[-2:]
        ds = self.mask_downsampler(masks, (16 * h, 16 * w))  # total stride 16 lands on the grid
        x = self.pix_feat_proj(pix_feat) + ds
        for layer in self.fuser["layers"]:
            x = layer(x)
        if self.out_proj is not None:
            x = self.out_proj(x)
        pos = sine_pos_grid(x.shape[-2], x.shape[-1], num_pos_feats=self.out_dim, device=x.device)
        return {"vision_features": x, "vision_pos_enc": pos[None].expand(x.shape).to(x.dtype)}


class RoPEAttention(nn.Module):
    """Single-head attention with axial RoPE on q and on k's first
    ``Lk - num_k_exclude_rope`` tokens (k's tables repeated when those span
    several frames of the q grid)."""

    def __init__(self, spec: Spec, embedding_dim: int, feat_sizes: Tuple[int, int],
                 kv_in_dim: Optional[int] = None, rope_k_repeat: bool = False):
        super().__init__()
        d, kv = embedding_dim, kv_in_dim or embedding_dim
        self.rope_k_repeat = rope_k_repeat
        self.q_proj = LoRALinear(d, d, spec)
        self.k_proj = LoRALinear(kv, d, spec)
        self.v_proj = LoRALinear(kv, d, spec)
        self.out_proj = LoRALinear(d, d, spec)
        ex, ey = feat_sizes
        cos, sin = rope_cos_sin(compute_axial_freqs(d, ex, ey))
        self.register_buffer("rope_cos", cos.to(spec.device), persistent=False)
        self.register_buffer("rope_sin", sin.to(spec.device), persistent=False)

    def forward(self, q, k, v, num_k_exclude_rope: int = 0,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        qh, kh, vh = (split_heads(t, 1) for t in (self.q_proj(q), self.k_proj(k), self.v_proj(v)))
        cos, sin = self.rope_cos, self.rope_sin
        lq = qh.shape[2]
        if lq != cos.shape[0]:
            raise ValueError(f"RoPE grid has {cos.shape[0]} positions, q has {lq} tokens")
        qh = apply_rope(qh, cos, sin)
        n_rope = kh.shape[2] - num_k_exclude_rope
        cos_k, sin_k = cos, sin
        if n_rope != lq:
            if not (self.rope_k_repeat and n_rope % lq == 0):
                raise ValueError(f"k has {n_rope} rotated tokens for a grid of {lq}")
            cos_k, sin_k = cos.repeat(n_rope // lq, 1), sin.repeat(n_rope // lq, 1)
        kh = torch.cat([apply_rope(kh[:, :, :n_rope], cos_k, sin_k), kh[:, :, n_rope:]], dim=2)
        out = dot_product_attention(qh, kh, vh, key_padding_mask=key_padding_mask)
        return self.out_proj(merge_heads(out))


class MemoryAttentionLayer(nn.Module):
    """Pre-norm: self attention, cross attention into the memory, FFN (2048
    wide, dropout 0.1 in training)."""

    def __init__(self, spec: Spec, d_model: int, kv_in_dim: int, feat_sizes: Tuple[int, int]):
        super().__init__()
        self.norm1 = LayerNorm(d_model, spec)
        self.self_attn = RoPEAttention(spec, d_model, feat_sizes)
        self.norm2 = LayerNorm(d_model, spec)
        self.cross_attn_image = RoPEAttention(spec, d_model, feat_sizes, kv_in_dim=kv_in_dim,
                                              rope_k_repeat=True)
        self.norm3 = LayerNorm(d_model, spec)
        self.linear1 = LoRALinear(d_model, 2048, spec)
        self.linear2 = LoRALinear(2048, d_model, spec)
        self.dropout = Dropout(0.1, spec)  # each branch's and the FFN's

    def forward(self, tgt, memory, query_pos, pos, num_obj_ptr_tokens: int = 0,
                memory_mask: Optional[torch.Tensor] = None):
        t2 = self.norm1(tgt)
        tgt = tgt + self.dropout(self.self_attn(t2, t2, t2))
        t2 = self.norm2(tgt)
        t2 = self.cross_attn_image(t2, memory + pos, memory, num_k_exclude_rope=num_obj_ptr_tokens,
                                   key_padding_mask=memory_mask)
        tgt = tgt + self.dropout(t2)
        t2 = self.norm3(tgt)
        t2 = self.linear2(self.dropout(F.relu(self.linear1(t2))))
        return tgt + self.dropout(t2)


class MemoryAttention(nn.Module):
    """4 memory-attention layers and a final LayerNorm."""

    def __init__(self, spec: Spec, d_model: int, kv_in_dim: int, feat_sizes: Tuple[int, int]):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(spec, d_model, kv_in_dim, feat_sizes)
                                    for _ in range(4))
        self.norm = LayerNorm(d_model, spec)

    def forward(self, src, memory, src_pos, memory_pos, num_obj_ptr_tokens: int = 0,
                memory_mask: Optional[torch.Tensor] = None):
        out = src + 0.1 * src_pos
        for layer in self.layers:
            out = layer(out, memory, src_pos, memory_pos, num_obj_ptr_tokens=num_obj_ptr_tokens,
                        memory_mask=memory_mask)
        return self.norm(out)


class TrackerCore(nn.Module):
    """One tracker step: memory-conditioned features -> SAM heads (batch =
    objects). The memory ``mem_feats`` (B, M, mem_dim) holds num_maskmem x
    Hm x Wm frame tokens, then the object-pointer slots (each pointer split
    into d_model / mem_dim tokens); ``mem_mask`` marks the unused slots."""

    NUM_MASKMEM, MAX_OBJ_PTRS = 7, 16  # memory frames; pointers in the temporal PE

    def __init__(self, spec: Spec, d_model: int, mem_dim: int, feat_sizes: Tuple[int, int]):
        super().__init__()
        cfg = spec.model
        self.spec = spec
        self.d_model, self.mem_dim = d_model, mem_dim
        self.transformer = nn.ModuleDict({"encoder": MemoryAttention(spec, d_model, mem_dim,
                                                                     feat_sizes)})
        self.maskmem_backbone = SimpleMaskEncoder(spec, out_dim=mem_dim, in_dim=d_model)
        self.sam_prompt_encoder = PromptEncoder(spec, embed_dim=d_model,
                                                image_embedding_size=feat_sizes,
                                                input_image_size=(cfg.img_size, cfg.img_size))
        self.sam_mask_decoder = MaskDecoder(spec, transformer_dim=d_model)
        self.maskmem_tpos_enc = spec.empty(self.NUM_MASKMEM, 1, 1, mem_dim, dtype=torch.float32)
        self.no_mem_embed = spec.empty(1, 1, d_model, dtype=torch.float32)
        self.no_mem_pos_enc = spec.empty(1, 1, d_model, dtype=torch.float32)
        self.no_obj_ptr = spec.empty(1, d_model, dtype=torch.float32)
        self.no_obj_embed_spatial = spec.empty(1, mem_dim, dtype=torch.float32)
        self.obj_ptr_proj = MLP(d_model, d_model, d_model, 3, spec)
        self.obj_ptr_tpos_proj = LoRALinear(d_model, mem_dim, spec)
        self.mask_downsample = Conv2d(1, 1, (4, 4), spec, stride=4)

    def init_parameters(self, g: torch.Generator) -> None:
        for p in (self.maskmem_tpos_enc, self.no_mem_embed, self.no_mem_pos_enc, self.no_obj_ptr,
                  self.no_obj_embed_spatial):
            trunc_normal_(p, 0.02, g)

    def condition_features(self, vision_feats, vision_pos, mem_feats, mem_pos,
                           mem_mask: Optional[torch.Tensor] = None, num_obj_ptr_tokens: int = 0):
        b, d, h, w = vision_feats.shape
        src = vision_feats.reshape(b, d, h * w).transpose(1, 2)
        pos = vision_pos.reshape(b, d, h * w).transpose(1, 2)
        out = self.transformer["encoder"](src, mem_feats, pos, mem_pos,
                                          num_obj_ptr_tokens=num_obj_ptr_tokens,
                                          memory_mask=mem_mask)
        return out.transpose(1, 2).reshape(b, d, h, w)

    def predict_masks(self, conditioned_feats, high_res_features: List[torch.Tensor],
                      point_coords: Optional[torch.Tensor] = None,
                      point_labels: Optional[torch.Tensor] = None,
                      multimask_output: bool = False):
        """-> (masks, iou, sam_tokens, object_score_logits); the high-res
        maps are the raw backbone ones (the decoder projects them)."""
        points = (point_coords, point_labels) if point_coords is not None else None
        sparse, dense = self.sam_prompt_encoder(points=points, batch=conditioned_feats.shape[0])
        return self.sam_mask_decoder(conditioned_feats, self.sam_prompt_encoder.get_dense_pe(),
                                     sparse, dense, multimask_output=multimask_output,
                                     high_res_features=high_res_features, project_high_res=True)

    def encode_memory(self, pix_feat, mask_logits, skip_sigmoid: bool = False,
                      object_score_logits: Optional[torch.Tensor] = None):
        """A frame and its mask -> memory features; with
        ``object_score_logits``, an occluded object (logit <= 0) gets the
        no-object spatial embedding added."""
        out = self.maskmem_backbone(pix_feat, mask_logits, skip_sigmoid)
        if object_score_logits is not None:
            is_obj = (object_score_logits > 0).float()  # (B, 1)
            feats = out["vision_features"]
            add = (1.0 - is_obj)[..., None, None] * self.no_obj_embed_spatial.float()[..., None, None]
            out["vision_features"] = feats + add.to(feats.dtype)
        return out

    def project_obj_ptr(self, sam_output_token, is_obj_appearing):
        """lam * MLP(token) + (1 - lam) * no_obj_ptr."""
        lam = is_obj_appearing.float()[..., None]
        return lam * self.obj_ptr_proj(sam_output_token) + (1.0 - lam) * self.no_obj_ptr

    def obj_ptr_tpos(self, rel_pos: torch.Tensor, max_abs_pos: int) -> torch.Tensor:
        """Temporal PE of the pointers: sine(rel / (max - 1)) -> mem_dim."""
        t_diff_max = max(max_abs_pos - 1, 1)
        return self.obj_ptr_tpos_proj(get_1d_sine_pe(rel_pos / t_diff_max, dim=self.d_model))

    def downsample_mask_input(self, masks: torch.Tensor) -> torch.Tensor:
        return self.mask_downsample(masks)

    def no_memory_features(self, vision_feats: torch.Tensor) -> torch.Tensor:
        """The conditioning frame's path: the no-memory embedding added, no
        memory attention."""
        return vision_feats + self.no_mem_embed.reshape(1, -1, 1, 1).to(vision_feats.dtype)

    def assemble_memory(self, maskmem_feats, maskmem_pos, maskmem_tpos, maskmem_valid,
                        obj_ptrs, obj_ptr_rel, obj_ptr_valid, num_frames: Optional[int] = None):
        """N memory slots (B, N, mem_dim, Hm, Wm) with their temporal
        positions and validity, P pointer slots (B, P, d_model) -> (mem,
        mem_pos, mem_mask True = pad, num_obj_ptr_tokens)."""
        b, n, c, hm, wm = maskmem_feats.shape
        l = hm * wm
        nm = self.NUM_MASKMEM
        tpos_emb = self.maskmem_tpos_enc[(nm - 1 - maskmem_tpos).clamp(0, nm - 1)]
        feats = maskmem_feats.reshape(b, n, c, l).transpose(2, 3)
        pos = maskmem_pos.reshape(b, n, c, l).transpose(2, 3) + tpos_emb.reshape(b, n, 1, c)
        feats, pos = feats.reshape(b, n * l, c), pos.reshape(b, n * l, c)
        mem_mask = (~maskmem_valid).repeat_interleave(l, dim=1)
        p = obj_ptrs.shape[1]
        r = self.d_model // self.mem_dim
        max_abs = min(num_frames, self.MAX_OBJ_PTRS) if num_frames else self.MAX_OBJ_PTRS
        ptr_pos = self.obj_ptr_tpos(obj_ptr_rel, max_abs).repeat_interleave(r, dim=1)
        ptr_tok = obj_ptrs.reshape(b, p * r, self.mem_dim)
        ptr_mask = (~obj_ptr_valid).repeat_interleave(r, dim=1)
        mem = torch.cat([feats, ptr_tok.to(feats.dtype)], dim=1)
        mem_pos = torch.cat([pos, ptr_pos.to(pos.dtype)], dim=1)
        return mem, mem_pos, torch.cat([mem_mask, ptr_mask], dim=1), p * r

    def forward(self, vision_feats, vision_pos, mem_feats, mem_pos, high_res_features,
                mem_mask: Optional[torch.Tensor] = None, num_obj_ptr_tokens: int = 0,
                multimask_output: bool = False) -> Dict[str, object]:
        cond = self.condition_features(vision_feats, vision_pos, mem_feats, mem_pos,
                                       mem_mask=mem_mask, num_obj_ptr_tokens=num_obj_ptr_tokens)
        masks, iou, tokens, obj_logits = self.predict_masks(cond, high_res_features,
                                                            multimask_output=multimask_output)
        return {
            "conditioned_features": cond,
            "masks": masks,
            "iou": iou,
            "sam_tokens": tokens,
            "object_score_logits": obj_logits,
            "new_memory": self.encode_memory(cond, masks[:, :1]),
        }
