"""Sam3Image: the promptable-detection forward pass (port of
``sam3_lora_tpu/models/sam3_image.py``).

  images --ViT+FPN--> fpn feats        token_ids --text enc--> text tokens
  (geo boxes) --geometry enc--> geo tokens
  prompt = [text | geo] --fusion encoder--> memory
  --decoder (presence token, boxRPB)--> hs / boxes / presence
  --dot-product scorer--> logits        --seg head--> masks

Module names mirror the reference state-dict prefixes
(backbone.vision_backbone.*, backbone.language_backbone.*,
geometry_encoder.*, transformer.{encoder,decoder}.*, segmentation_head.*,
dot_prod_scoring.*). Output keys mirror the JAX model's output, with a
leading ``layers`` axis on the per-layer predictions.

With targets in the batch the training branch runs (in train or eval mode,
as in the JAX model, so a validation loss sees the same outputs without
dropout): DAC query doubling gives the ``*_o2m`` outputs, every layer's
predictions are matched to the targets (one-to-one for all layers and the
aux o2m layers, solved exactly on the host in one transfer; top-k
one-to-many for the last o2m layer), and the segmentation head runs on the
matched queries only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.boxes import box_cxcywh_to_xyxy
from ..train.matcher import hungarian_match, one_to_many_match
from ..utils.logging import trace_span
from .decoder import TransformerDecoder
from .fusion_encoder import TransformerEncoderFusion
from .geometry import GeometryEncoder, GeoPrompt
from .layers import Spec
from .neck import FPNNeck
from .scoring import DotProductScoring
from .seg_head import UniversalSegmentationHead
from .text_encoder import VETextEncoder
from .vit import ViT


@dataclasses.dataclass
class Targets:
    """Static-shape per-query ground truth, padded to T slots."""

    boxes: torch.Tensor                 # (B, T, 4) normalized cxcywh, zero-padded
    valid: torch.Tensor                 # (B, T) bool
    masks: Optional[torch.Tensor]       # (B, T, Hm, Wm) {0, 1} (bool or float)
    mask_valid: Optional[torch.Tensor]  # (B, T) bool
    is_exhaustive: torch.Tensor         # (B,) bool


@dataclasses.dataclass
class Batch:
    """Model input: images (N_img, 3, R, R) normalized (or uint8),
    token_ids (B, ctx), img_ids (B,) index into images, optional geometry,
    optional targets (the training branch)."""

    images: torch.Tensor
    token_ids: torch.Tensor
    img_ids: torch.Tensor
    geo: Optional[GeoPrompt] = None
    targets: Optional[Targets] = None


class Sam3Image(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        self.spec = spec
        self.backbone = nn.Module()
        self.backbone.vision_backbone = FPNNeck(spec)
        # the reference nests the ViT trunk under the neck's prefix
        self.backbone.vision_backbone.trunk = ViT(spec)
        self.backbone.language_backbone = VETextEncoder(spec)
        self.geometry_encoder = GeometryEncoder(spec)
        self.transformer = nn.Module()
        self.transformer.encoder = TransformerEncoderFusion(spec)
        self.transformer.decoder = TransformerDecoder(spec)
        self.segmentation_head = UniversalSegmentationHead(spec)
        self.dot_prod_scoring = DotProductScoring(spec)

    def seed_dropout(self, seed: int) -> None:
        """Seed the dropout masks that training mode draws (every module of
        the model shares one ``DropoutRNG``)."""
        self.spec.rng.seed(seed, next(self.parameters()).device)

    def backbone_image(self, images: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(N, 3, R, R) -> FPN features and position encodings, high -> low
        res, with the lowest ``scalp`` levels dropped."""
        vb = self.backbone.vision_backbone
        feats, poss = vb(vb.trunk(images))
        scalp = self.spec.model.scalp
        if scalp > 0:
            feats, poss = feats[:-scalp], poss[:-scalp]
        return feats, poss

    def forward(self, batch: Batch) -> Dict[str, Any]:
        feats, poss = self.backbone_image(batch.images)
        return self.ground(feats, poss, batch)

    def ground(self, feats, poss, batch: Batch) -> Dict[str, Any]:
        """Prompt-conditioned grounding over precomputed image features."""
        cfg = self.spec.model
        b = batch.token_ids.shape[0]
        d = cfg.d_model
        text_mask, text_tokens = self.backbone.language_backbone(batch.token_ids)

        feats = [f[batch.img_ids] for f in feats]
        poss = [p[batch.img_ids] for p in poss]
        h, w = feats[-1].shape[-2:]
        img_tokens = feats[-1].reshape(b, d, h * w).transpose(1, 2)
        img_pos = poss[-1].reshape(b, d, h * w).transpose(1, 2)

        geo = batch.geo or GeoPrompt.empty(b, cfg.max_prompt_boxes, device=img_tokens.device)
        geo_tokens, geo_mask = self.geometry_encoder(geo, img_tokens, img_pos, (h, w))

        prompt = torch.cat([text_tokens, geo_tokens], dim=1)
        prompt_mask = torch.cat([text_mask, geo_mask], dim=1)
        memory = self.transformer.encoder(img_tokens, img_pos, prompt, prompt_mask)
        tgt = batch.targets
        apply_dac = cfg.dac and tgt is not None
        dec = self.transformer.decoder(memory, img_pos, prompt, prompt_mask, (h, w),
                                       apply_dac=apply_dac)
        hs, nq = dec.hs, cfg.num_queries  # hs (L, B, nq or 2 nq, D)
        logits = self.dot_prod_scoring(hs, prompt, prompt_mask)
        coords = dec.pred_coords
        out: Dict[str, Any] = {
            "pred_logits": logits[:, :, :nq],                 # (L, B, Q, 1)
            "pred_boxes": coords[:, :, :nq],                  # (L, B, Q, 4) cxcywh
            "pred_boxes_xyxy": box_cxcywh_to_xyxy(coords[:, :, :nq]),
            "presence_logit_dec": dec.presence_logits,        # (L, B, 1)
            "presence_feats": dec.presence_feats,
            "encoder_hidden_states": memory,
            "prompt": prompt,
            "prompt_mask": prompt_mask,
        }
        if tgt is None:
            seg = self.segmentation_head(feats, memory, hs[-1], prompt, prompt_mask, (h, w))
            out["pred_masks"] = seg["pred_masks"]             # (B, Q, Hm, Wm)
            out["semantic_seg"] = seg["semantic_seg"]
            return out

        n_layers = hs.shape[0]
        with trace_span("sam3.match"):
            if apply_dac:
                out["pred_logits_o2m"] = logits[:, :, nq:]
                out["pred_boxes_o2m"] = coords[:, :, nq:]
                out["pred_boxes_xyxy_o2m"] = box_cxcywh_to_xyxy(coords[:, :, nq:])
                # one exact solve for the o2o matchings of every layer and the aux
                # o2m matchings of layers 0..L-2; the last o2m layer is top-k
                n_prob = 2 * n_layers - 1
                idx = hungarian_match(
                    torch.cat([out["pred_logits"], out["pred_logits_o2m"][:-1]]),
                    torch.cat([out["pred_boxes"], out["pred_boxes_o2m"][:-1]]),
                    tgt.boxes.expand(n_prob, *tgt.boxes.shape),
                    tgt.valid.expand(n_prob, *tgt.valid.shape),
                )
                out["indices"] = idx[:n_layers]                   # (L, B, T)
                k = cfg.o2m_topk
                aux_qi = idx[n_layers:]                           # (L-1, B, T)
                aux_qv = (aux_qi >= 0) & tgt.valid
                aux_qi = torch.cat([aux_qi.clamp(min=0)[..., None],
                                    aux_qi.new_zeros(*aux_qi.shape, k - 1)], dim=-1)
                aux_qv = torch.cat([aux_qv[..., None], aux_qv.new_zeros(*aux_qv.shape, k - 1)],
                                   dim=-1)
                last_qi, last_qv = one_to_many_match(
                    out["pred_logits_o2m"][-1], out["pred_boxes_o2m"][-1],
                    tgt.boxes, tgt.valid, topk=k,
                )
                out["o2m_indices"] = torch.cat([aux_qi, last_qi[None]])  # (L, B, T, K)
                out["o2m_valid"] = torch.cat([aux_qv, last_qv[None]])
            else:
                out["indices"] = hungarian_match(
                    out["pred_logits"], out["pred_boxes"],
                    tgt.boxes.expand(n_layers, *tgt.boxes.shape),
                    tgt.valid.expand(n_layers, *tgt.valid.shape),
                )

        # the seg head runs on the matched queries only: o2o of the last
        # layer, then (DAC) its o2m matches
        last = hs[-1]
        rows = torch.arange(b, device=last.device)[:, None]
        sel = [last[rows, out["indices"][-1].clamp(min=0)]]
        if apply_dac:
            sel.append(last[rows, out["o2m_indices"][-1].clamp(min=0).reshape(b, -1) + nq])
        seg = self.segmentation_head(feats, memory, torch.cat(sel, dim=1), prompt,
                                     prompt_mask, (h, w))
        masks = seg["pred_masks"]
        t = out["indices"].shape[-1]
        out["pred_masks_matched"] = masks[:, :t]               # (B, T, Hm, Wm)
        if apply_dac:
            out["pred_masks_o2m_matched"] = masks[:, t:].reshape(b, t, -1, *masks.shape[-2:])
        out["semantic_seg"] = seg["semantic_seg"]
        return out
