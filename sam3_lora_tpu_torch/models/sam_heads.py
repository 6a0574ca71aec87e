"""SAM interactive heads (port of ``sam3_lora_tpu/models/sam_heads.py``):
``PromptEncoder`` + ``TwoWayTransformer`` + ``MaskDecoder`` with the
tracker's settings (d 256, two-way depth 2, mlp 2048, 8 heads, 3 + 1 mask
tokens, high-res features, sigmoid IoU head, an object-score token, dynamic
multimask by stability).

Module and parameter names are the JAX package's, which mirror the torch
state dict with its Sequential indices (``mask_downscaling.{0,1,3,4,6}``,
``output_upscaling.{0,1,3}``), so a JAX param tree loads through the weight
bridge. The transposed convs keep the torch layout (in, out, 2, 2) under the
leaf name ``weight``, which the bridge leaves as it is.

Point prompts arrive padded to a fixed count with label -1 for an empty
slot; masks are decoded for all 4 tokens and single or multimask output is
a selection. The attention is the plain ``dot_product_attention``: the JAX
heads run no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention, merge_heads, split_heads
from .layers import MLP, Conv2d, Embedding, LayerNorm, LoRALinear, Spec, uniform_


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over (B, C, H, W), fp32 statistics."""

    def __init__(self, channels: int, spec: Spec, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = spec.empty(channels, dtype=torch.float32)
        self.bias = spec.empty(channels, dtype=torch.float32)

    def init_parameters(self, g: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(1, keepdim=True)
        var = ((xf - mean) ** 2).mean(1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


class ConvTranspose2d(nn.Module):
    """torch ConvTranspose2d(k=2, s=2) on the torch-layout weight (in, out, 2, 2)."""

    def __init__(self, in_ch: int, features: int, spec: Spec):
        super().__init__()
        self.spec, self.features = spec, features
        self.weight = spec.empty(in_ch, features, 2, 2)
        self.bias = spec.empty(features)

    def init_parameters(self, g: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.features * 4)
        uniform_(self.weight, bound, g)
        uniform_(self.bias, bound, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.spec.dtype
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), stride=2)
        return y + self.bias.to(dt)[None, :, None, None]


class SamAttention(nn.Module):
    """Separate q/k/v/out projections with an internal downsampled width."""

    def __init__(self, embedding_dim: int, num_heads: int, spec: Spec, downsample_rate: int = 1):
        super().__init__()
        d_int = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = LoRALinear(embedding_dim, d_int, spec)
        self.k_proj = LoRALinear(embedding_dim, d_int, spec)
        self.v_proj = LoRALinear(embedding_dim, d_int, spec)
        self.out_proj = LoRALinear(d_int, embedding_dim, spec)

    def forward(self, q, k, v):
        h = self.num_heads
        out = dot_product_attention(split_heads(self.q_proj(q), h), split_heads(self.k_proj(k), h),
                                    split_heads(self.v_proj(v), h))
        return self.out_proj(merge_heads(out))


class MLPBlock(nn.Module):
    """lin1 -> relu -> lin2."""

    def __init__(self, dim: int, mlp_dim: int, spec: Spec):
        super().__init__()
        self.lin1 = LoRALinear(dim, mlp_dim, spec)
        self.lin2 = LoRALinear(mlp_dim, dim, spec)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


# the tracker's two-way transformer: depth 2, 8 heads, MLP 2048, the
# cross-attentions at half width
TWOWAY_DEPTH, TWOWAY_HEADS, TWOWAY_MLP, TWOWAY_DOWNSAMPLE = 2, 8, 2048, 2


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, spec: Spec, embedding_dim: int, skip_first_layer_pe: bool):
        super().__init__()
        d, h, r = embedding_dim, TWOWAY_HEADS, TWOWAY_DOWNSAMPLE
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = SamAttention(d, h, spec)
        self.norm1 = LayerNorm(d, spec)
        self.cross_attn_token_to_image = SamAttention(d, h, spec, downsample_rate=r)
        self.norm2 = LayerNorm(d, spec)
        self.mlp = MLPBlock(d, TWOWAY_MLP, spec)
        self.norm3 = LayerNorm(d, spec)
        self.cross_attn_image_to_token = SamAttention(d, h, spec, downsample_rate=r)
        self.norm4 = LayerNorm(d, spec)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, spec: Spec, embedding_dim: int):
        super().__init__()
        d = embedding_dim
        self.layers = nn.ModuleList(TwoWayAttentionBlock(spec, d, skip_first_layer_pe=(i == 0))
                                    for i in range(TWOWAY_DEPTH))
        self.final_attn_token_to_image = SamAttention(d, TWOWAY_HEADS, spec,
                                                      downsample_rate=TWOWAY_DOWNSAMPLE)
        self.norm_final_attn = LayerNorm(d, spec)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe (B, C, H, W), point_embedding (B, N, C)
        -> (queries (B, N, C), keys (B, HW, C))."""
        b, c, h, w = image_embedding.shape
        keys = image_embedding.reshape(b, c, h * w).transpose(1, 2)
        key_pe = image_pe.reshape(b, c, h * w).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


def random_position_embedding(coords: torch.Tensor, gaussian_matrix: torch.Tensor) -> torch.Tensor:
    """Fourier features of coords in [0, 1]: (..., 2) -> (..., 2 * npf)."""
    c = 2.0 * coords - 1.0
    c = 2.0 * math.pi * (c @ gaussian_matrix.to(c.dtype))
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class _PELayer(nn.Module):
    def __init__(self, d: int, spec: Spec):
        super().__init__()
        self.positional_encoding_gaussian_matrix = spec.empty(2, d // 2, dtype=torch.float32)

    def init_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.positional_encoding_gaussian_matrix.normal_(0.0, 1.0, generator=g)


class PromptEncoder(nn.Module):
    """Point, box and mask prompts -> (sparse (B, N, D), dense (B, D, H, W)).
    Point labels: -1 pad, 0 negative, 1 positive, 2 / 3 box corners."""

    def __init__(self, spec: Spec, embed_dim: int, image_embedding_size: Tuple[int, int],
                 input_image_size: Tuple[int, int]):
        super().__init__()
        d, ch = embed_dim, 16  # the mask downscaler's width
        self.spec, self.embed_dim = spec, d
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = _PELayer(d, spec)
        self.point_embeddings = nn.ModuleList(Embedding(1, d, spec) for _ in range(4))
        self.not_a_point_embed = Embedding(1, d, spec)
        self.no_mask_embed = Embedding(1, d, spec)
        self.mask_downscaling = nn.ModuleDict({
            "0": Conv2d(1, ch // 4, (2, 2), spec, stride=2),
            "1": LayerNorm2d(ch // 4, spec),
            "3": Conv2d(ch // 4, ch, (2, 2), spec, stride=2),
            "4": LayerNorm2d(ch, spec),
            "6": Conv2d(ch, d, (1, 1), spec),
        })

    @property
    def pe_gaussian(self) -> torch.Tensor:
        return self.pe_layer.positional_encoding_gaussian_matrix

    def get_dense_pe(self) -> torch.Tensor:
        h, w = self.image_embedding_size
        dev = self.pe_gaussian.device
        gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack([gx[None, :].expand(h, w), gy[:, None].expand(h, w)], -1)
        return random_position_embedding(grid, self.pe_gaussian).permute(2, 0, 1)[None]

    def _scale(self, device) -> torch.Tensor:
        ih, iw = self.input_image_size
        return torch.tensor([iw, ih], dtype=torch.float32, device=device)

    def embed_points(self, coords: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """coords (B, P, 2) absolute pixels, labels (B, P) int."""
        pe = random_position_embedding((coords + 0.5) / self._scale(coords.device), self.pe_gaussian)
        pad = (labels == -1)[..., None]
        emb = torch.where(pad, 0.0, pe)
        emb = emb + torch.where(pad, self.not_a_point_embed()[0], 0.0)
        for lbl, table in enumerate(self.point_embeddings):
            emb = emb + torch.where((labels == lbl)[..., None], table()[0], 0.0)
        return emb

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes (B, Nb, 4) absolute xyxy -> (B, 2 Nb, D) corner tokens."""
        b, nb, _ = boxes.shape
        corners = (boxes.reshape(b, nb, 2, 2) + 0.5) / self._scale(boxes.device)
        pe = random_position_embedding(corners, self.pe_gaussian)
        corner = torch.stack([self.point_embeddings[2]()[0], self.point_embeddings[3]()[0]])
        return (pe + corner).reshape(b, nb * 2, -1)

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        m = self.mask_downscaling
        x = F.gelu(m["1"](m["0"](masks)))
        x = F.gelu(m["4"](m["3"](x)))
        return m["6"](x)

    def forward(self, points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                boxes: Optional[torch.Tensor] = None, masks: Optional[torch.Tensor] = None,
                batch: int = 1):
        sparse = []
        bs = batch
        if points is not None:
            coords, labels = points
            bs = coords.shape[0]
            if boxes is None:  # one "not a point" slot, as the reference pads
                coords = F.pad(coords, (0, 0, 0, 1))
                labels = F.pad(labels, (0, 1), value=-1)
            sparse.append(self.embed_points(coords, labels))
        if boxes is not None:
            bs = boxes.shape[0]
            sparse.append(self.embed_boxes(boxes))
        dev = self.pe_gaussian.device
        sparse_emb = torch.cat(sparse, dim=1) if sparse else torch.zeros((bs, 0, self.embed_dim),
                                                                          device=dev)
        if masks is not None:
            return sparse_emb, self.embed_masks(masks)
        h, w = self.image_embedding_size
        dense = self.no_mask_embed()[0][None, :, None, None].expand(bs, self.embed_dim, h, w)
        return sparse_emb, dense


class MaskDecoder(nn.Module):
    """The SAM mask decoder with the tracker's settings: 3 + 1 mask tokens,
    a 3-layer IoU head (256 wide, sigmoid), the object-score token and its
    head, high-res features, the multimask tokens for the object pointer, and
    the single output chosen by stability (``_dynamic_multimask``)."""

    NUM_MASK_TOKENS = 4
    STABILITY_DELTA, STABILITY_THRESH = 0.05, 0.98

    def __init__(self, spec: Spec, transformer_dim: int):
        super().__init__()
        d, nm = transformer_dim, self.NUM_MASK_TOKENS
        self.spec, self.d = spec, d
        self.iou_token = Embedding(1, d, spec)
        self.mask_tokens = Embedding(nm, d, spec)
        self.obj_score_token = Embedding(1, d, spec)
        self.pred_obj_score_head = MLP(d, d, 1, 3, spec)
        self.transformer = TwoWayTransformer(spec, d)
        self.output_upscaling = nn.ModuleDict({
            "0": ConvTranspose2d(d, d // 4, spec),
            "1": LayerNorm2d(d // 4, spec),
            "3": ConvTranspose2d(d // 4, d // 8, spec),
        })
        self.conv_s0 = Conv2d(d, d // 8, (1, 1), spec)
        self.conv_s1 = Conv2d(d, d // 4, (1, 1), spec)
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(d, d, d // 8, 3, spec) for _ in range(nm))
        self.iou_prediction_head = MLP(d, 256, nm, 3, spec)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool,
                high_res_features: List[torch.Tensor], project_high_res: bool = False):
        """image_embeddings (B, C, H, W), image_pe (1, C, H, W), sparse (B, N,
        C), dense (B, C, H, W). ``high_res_features`` [s0 (B, *, 4H, 4W), s1
        (B, *, 2H, 2W)]: raw backbone maps run through conv_s0 / conv_s1 when
        ``project_high_res``, else already projected. -> (masks, iou,
        sam_tokens, object_score_logits)."""
        d, nm = self.d, self.NUM_MASK_TOKENS
        b = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.obj_score_token(), self.iou_token(), self.mask_tokens()])
        tokens = torch.cat([output_tokens[None].expand(b, *output_tokens.shape),
                            sparse_prompt_embeddings], dim=1)
        src = image_embeddings + dense_prompt_embeddings
        pos_src = image_pe.expand(src.shape)
        h, w = src.shape[-2:]
        hs, src_out = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, 1]
        mask_tokens_out = hs[:, 2:2 + nm]

        src_grid = src_out.transpose(1, 2).reshape(b, d, h, w)
        up_mods = self.output_upscaling
        feat_s0, feat_s1 = high_res_features
        if project_high_res:
            feat_s0, feat_s1 = self.conv_s0(feat_s0), self.conv_s1(feat_s1)
        up = F.gelu(up_mods["1"](up_mods["0"](src_grid) + feat_s1))
        up = F.gelu(up_mods["3"](up) + feat_s0)

        dt = self.spec.dtype
        hyper = torch.stack([mlp(mask_tokens_out[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        # operands rounded to the compute dtype, fp32 sums (JAX's
        # preferred_element_type=float32)
        masks = torch.einsum("bnc,bchw->bnhw", hyper.to(dt).float(), up.to(dt).float())
        iou_pred = torch.sigmoid(self.iou_prediction_head(iou_token_out))
        object_score_logits = self.pred_obj_score_head(hs[:, 0])

        if multimask_output:
            out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            if self.training:
                out_masks, out_iou = masks[:, :1], iou_pred[:, :1]
            else:
                out_masks, out_iou = self._dynamic_multimask(masks, iou_pred)
            sam_tokens_out = mask_tokens_out[:, :1]
        return out_masks, out_iou, sam_tokens_out, object_score_logits

    def _dynamic_multimask(self, all_masks: torch.Tensor, all_iou: torch.Tensor):
        """The single-mask output unless its stability (the area above
        +delta over the area above -delta) is under the threshold; then the
        multimask output of the highest IoU (the first on a tie)."""
        multi, multi_iou = all_masks[:, 1:], all_iou[:, 1:]
        best = torch.argmax(multi_iou, dim=-1)
        bidx = torch.arange(all_masks.shape[0], device=all_masks.device)
        best_masks = multi[bidx, best][:, None]
        best_iou = multi_iou[bidx, best][:, None]
        single = all_masks[:, :1]
        flat = single.reshape(single.shape[0], -1)
        delta = self.STABILITY_DELTA
        area_i = (flat > delta).sum(-1).float()
        area_u = (flat > -delta).sum(-1).float()
        stability = torch.where(area_u > 0, area_i / area_u, 1.0)
        is_stable = (stability >= self.STABILITY_THRESH)[:, None]
        out_masks = torch.where(is_stable[..., None, None], single, best_masks)
        out_iou = torch.where(is_stable, all_iou[:, :1], best_iou)
        return out_masks, out_iou
