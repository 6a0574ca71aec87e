"""The reference's own inputs and steps: it decodes the raw files, rebuilds
the batches, trains and serves, from nothing the program made.

* ``train_batch``: a COCO split's images by id -> the padded training batch,
  with PIL for every pixel operation (decode; polygons drawn with outline
  and fill; the image resized to the square input by BILINEAR, the masks by
  NEAREST; the masks area-reduced to the loss resolution by BILINEAR and
  kept above 0.5), one query an image (its most frequent category), boxes
  normalized cxcywh, ``max_targets`` slots.
* ``loader_order``: the images of a training epoch in the loader's seeded
  order (``numpy.random.RandomState(seed + epoch).shuffle``).
* ``train_steps``: updates of the adapters: the loss of the training branch,
  backward, the global-norm clip (scaled by max/norm when the norm reaches
  max), AdamW with decoupled decay, and the schedule (linear warmup from 0,
  then cosine to 1% of the peak), each written out here.
* ``detect``: one image and its prompts through the eval forward: every
  query's score, presence, box and mask probability, then the answers of
  ``SAM3LoRAInference.predict`` or ``Sam3Processor.set_text_prompt``
  (masks resized by PIL BILINEAR on 0/255 and kept above 127.5).
"""

from __future__ import annotations

import json
import math
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from .geometry import GeoPrompt
from .losses import LossConfig, compute_losses
from .sam3_image import Batch, Targets
from .tokenizer import get_default_tokenizer


def _pil_resize(arr: np.ndarray, w: int, h: int, nearest: bool = False) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(arr).resize(
        (w, h), Image.NEAREST if nearest else Image.BILINEAR))


def _polygons(polys, h: int, w: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) >= 3:
            draw.polygon([tuple(p) for p in pts], outline=1, fill=1)
    return np.asarray(img, np.uint8)


def loader_order(n: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    return order


def train_batch(split_dir: str, ids: Sequence[int], cfg, device) -> Batch:
    from PIL import Image

    split = Path(split_dir)
    coco = json.loads((split / "_annotations.coco.json").read_text())
    images = {im["id"]: im for im in coco["images"]}
    cats = {c["id"]: c["name"] for c in coco["categories"]}
    anns: Dict[int, list] = {}
    for a in coco["annotations"]:
        anns.setdefault(a["image_id"], []).append(a)
    order = sorted(images)
    r, t_max, m_res = cfg.img_size, cfg.max_targets, cfg.mask_loss_resolution
    imgs, texts, boxes, valid, masks, mvalid = [], [], [], [], [], []
    for i in ids:
        info = images[order[i]]
        arr = np.asarray(Image.open(split / info["file_name"]).convert("RGB"), np.uint8)
        h, w = arr.shape[:2]
        imgs.append(_pil_resize(arr, r, r).transpose(2, 0, 1))
        b = np.zeros((t_max, 4), np.float32)
        v = np.zeros((t_max,), bool)
        m = np.zeros((t_max, m_res, m_res), bool)
        mv = np.zeros((t_max,), bool)
        names = []
        objs = anns.get(info["id"], [])
        for j, a in enumerate(objs[:t_max]):
            x, y, bw, bh = a["bbox"]
            sx, sy = r / w, r / h
            x0, y0, x1, y1 = (np.float32(x) * np.float32(sx), np.float32(y) * np.float32(sy),
                              np.float32(x + bw) * np.float32(sx),
                              np.float32(y + bh) * np.float32(sy))
            b[j] = [(x0 + x1) / 2 / r, (y0 + y1) / 2 / r, (x1 - x0) / r, (y1 - y0) / r]
            v[j] = True
            full = _pil_resize(_polygons(a["segmentation"], h, w), r, r, nearest=True)
            if full.any():
                small = _pil_resize((full.astype(np.float32) * 255).astype(np.uint8), m_res, m_res)
                m[j] = (small.astype(np.float32) / 255.0) > 0.5
                mv[j] = True
        names = [cats.get(a.get("category_id", 0), "object") for a in objs]
        texts.append(Counter(names).most_common(1)[0][0].lower() if names else "object")
        boxes.append(b), valid.append(v), masks.append(m), mvalid.append(mv)
    tok = get_default_tokenizer()
    ids_t = np.asarray(tok(texts, context_length=cfg.text_context_length), np.int64)
    n = len(ids)
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(np.stack(a)).to(dev)  # noqa: E731
    return Batch(
        images=as_t(imgs), token_ids=torch.from_numpy(ids_t).to(dev),
        img_ids=torch.arange(n, device=dev),
        geo=GeoPrompt.empty(n, cfg.max_prompt_boxes, device=dev),
        targets=Targets(boxes=as_t(boxes), valid=as_t(valid), masks=as_t(masks),
                        mask_valid=as_t(mvalid),
                        is_exhaustive=torch.ones((n,), dtype=torch.bool, device=dev)),
    )


def lr_at(step: int, tcfg: dict, steps_per_epoch: int) -> float:
    total = max(1, tcfg["num_epochs"] * steps_per_epoch // max(1, tcfg["gradient_accumulation_steps"]))
    warmup = min(tcfg["warmup_steps"], max(total - 1, 1))
    peak = tcfg["learning_rate"]
    if tcfg["lr_scheduler"] == "constant":
        return peak
    if tcfg["lr_scheduler"] != "cosine":
        raise ValueError(f"the reference has no schedule {tcfg['lr_scheduler']!r}")
    if step < warmup:
        return peak * step / warmup
    t = min(step - warmup, total - warmup)
    return peak * (0.99 * 0.5 * (1 + math.cos(math.pi * t / (total - warmup))) + 0.01)


def train_steps(model, named: List, batches: List[Batch], tcfg: dict, seed: int,
                steps_per_epoch: int):
    """Run ``len(batches)`` updates from the adapters' current values.
    Returns (core losses, every step's presence-loss terms by name, the
    first update's clipped gradients by name)."""
    params = [p for _, p in named]
    b1, b2, eps = tcfg["adam_beta1"], tcfg["adam_beta2"], tcfg["adam_epsilon"]
    wd, max_norm = tcfg["weight_decay"], tcfg["max_grad_norm"]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, presence, first = [], [], None
    model.train()
    for step, batch in enumerate(batches):
        # the trainer's dropout seed of update ``step`` at rank 0
        model.seed_dropout((seed * 1_000_003 + step) % 2 ** 62)
        out = model(batch)
        terms = compute_losses(out, batch.targets, LossConfig())
        terms["core_loss"].backward()
        losses.append(float(terms["core_loss"].detach()))
        presence.append({k: float(v.detach()) for k, v in terms.items()
                         if k.startswith("presence_loss")})
        with torch.no_grad():
            grads = [p.grad for p in params]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            if norm >= max_norm:
                grads = [g * (max_norm / norm) for g in grads]
            if first is None:
                first = {n: g.detach().clone() for (n, _), g in zip(named, grads)}
            lr = lr_at(step, tcfg, steps_per_epoch)
            t = step + 1
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.mul_(1 - lr * wd)
                denom = (vi.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(mi, denom, value=-lr / (1 - b1 ** t))
            for p in params:
                p.grad = None
        del out
    model.eval()
    return losses, presence, first


def preprocess(image: np.ndarray, r: int, device) -> torch.Tensor:
    """(H, W, 3) uint8 -> (1, 3, R, R) float32: PIL BILINEAR, then
    (x / 255 - 0.5) / 0.5."""
    x = _pil_resize(np.ascontiguousarray(image[..., :3]), r, r).astype(np.float32)
    x = (x / np.float32(255.0) - np.float32(0.5)) / np.float32(0.5)
    return torch.from_numpy(x.transpose(2, 0, 1)[None].copy()).to(device)


@torch.no_grad()
def detect(model, image: np.ndarray, prompts: Sequence[str], device):
    """Every query of each prompt on one image: scores (P, Q), presence (P,),
    boxes (P, Q, 4) cxcywh, mask probabilities (P, Q, m, m), float32."""
    cfg = model.spec.model
    x = preprocess(image, cfg.img_size, device)
    tok = get_default_tokenizer()
    ids = torch.from_numpy(np.asarray(tok([p.lower() for p in prompts],
                                          context_length=cfg.text_context_length), np.int64))
    b = len(prompts)
    batch = Batch(images=x, token_ids=ids.to(device),
                  img_ids=torch.zeros((b,), dtype=torch.long, device=device),
                  geo=GeoPrompt.empty(b, cfg.max_prompt_boxes, device=device))
    model.eval()
    out = model(batch)
    return (torch.sigmoid(out["pred_logits"][-1][..., 0].float()),
            torch.sigmoid(out["presence_logit_dec"][-1][..., 0].float()),
            out["pred_boxes"][-1].float(), torch.sigmoid(out["pred_masks"].float()))


def answers(scores, presence, boxes, masks, hw, threshold: float, kind: str,
            margin: float = 0.1):
    """The answers of one prompt (``kind`` "predict": plain scores, masks at
    the original size; "processor": scores times presence, masks at the
    model's resolution) as {scores, boxes (xyxy, original pixels), masks},
    with the kept masks' probabilities (``probs``, processor) or, for
    predict, ``sure``: the original-size pixels that only low-resolution
    pixels more than ``margin`` from 0.5 reach through the resize."""
    s = scores.cpu().numpy() * (float(presence) if kind == "processor" else 1.0)
    keep = s > threshold
    h, w = hw
    cx, cy, bw, bh = boxes.cpu().numpy().T
    xyxy = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w,
                     (cy + bh / 2) * h], axis=-1)
    probs = masks[torch.from_numpy(keep).to(masks.device)]
    low = (probs > 0.5).cpu().numpy()
    if kind == "predict":
        low = np.stack([_pil_resize(m.astype(np.uint8) * 255, w, h) > 127.5 for m in low]) \
            if len(low) else np.zeros((0, h, w), bool)
    out = {"scores": s[keep], "boxes": xyxy[keep], "masks": low, "all_scores": s,
           "all_boxes": xyxy}
    if kind == "processor":
        out["probs"] = probs.cpu().numpy()
    else:
        unsure = (probs.float() - 0.5).abs().le(margin).cpu().numpy()
        out["sure"] = [_pil_resize(u.astype(np.uint8) * 255, w, h) == 0 for u in unsure]
    return out
