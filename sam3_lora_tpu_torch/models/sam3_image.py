"""Sam3Image: the promptable-detection forward pass, eval branch (port of
``sam3_lora_tpu/models/sam3_image.py``).

  images --ViT+FPN--> fpn feats        token_ids --text enc--> text tokens
  (geo boxes) --geometry enc--> geo tokens
  prompt = [text | geo] --fusion encoder--> memory
  --decoder (presence token, boxRPB)--> hs / boxes / presence
  --dot-product scorer--> logits        --seg head--> masks

Module names mirror the reference state-dict prefixes
(backbone.vision_backbone.*, backbone.language_backbone.*,
geometry_encoder.*, transformer.{encoder,decoder}.*, segmentation_head.*,
dot_prod_scoring.*). Output keys mirror the JAX model's eval output, with a
leading ``layers`` axis on the per-layer predictions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.boxes import box_cxcywh_to_xyxy
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
class Batch:
    """Model input: images (N_img, 3, R, R) normalized (or uint8),
    token_ids (B, ctx), img_ids (B,) index into images, optional geometry."""

    images: torch.Tensor
    token_ids: torch.Tensor
    img_ids: torch.Tensor
    geo: Optional[GeoPrompt] = None


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
        dec = self.transformer.decoder(memory, img_pos, prompt, prompt_mask, (h, w))
        logits = self.dot_prod_scoring(dec.hs, prompt, prompt_mask)
        coords = dec.pred_coords
        seg = self.segmentation_head(feats, memory, dec.hs[-1], prompt, prompt_mask, (h, w))
        return {
            "pred_logits": logits,                          # (L, B, Q, 1)
            "pred_boxes": coords,                           # (L, B, Q, 4) cxcywh
            "pred_boxes_xyxy": box_cxcywh_to_xyxy(coords),
            "presence_logit_dec": dec.presence_logits,      # (L, B, 1)
            "presence_feats": dec.presence_feats,
            "encoder_hidden_states": memory,
            "prompt": prompt,
            "prompt_mask": prompt_mask,
            "pred_masks": seg["pred_masks"],                # (B, Q, Hm, Wm)
            "semantic_seg": seg["semantic_seg"],
        }
