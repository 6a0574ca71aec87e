"""Connected components and the Euclidean distance transform (port of
``sam3_lora_tpu/ops/cc.py``), on the device.

* ``connected_components``: 8-connected labelling by label propagation,
  with the JAX function's exact iteration structure: ``max_iters`` (32)
  sweeps, each a 3x3 neighbourhood min, the hook (each pixel's root adopts
  a smaller neighbour label by scatter-min) and 12 pointer jumps (label <-
  label[label]). It does not iterate to a fixpoint: the labels at the cap
  are the reference's. It takes a leading batch of masks, where JAX maps
  one mask at a time; each mask is labelled on its own, so the labels are
  the same.
* ``edt``: the exact squared Euclidean distance transform, two separable
  O(N^2) min-plus passes blocked over ``chunk`` columns.
* ``sample_point_from_error_region``: the corrective click of interactive
  refinement, the deepest pixel (largest EDT) of the larger error region.

The video tier fills holes and removes sprinkles with them
(``video.py::fill_holes_in_mask_scores``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

JUMPS = 12  # pointer jumps per sweep


def _neighbour_min(labels: torch.Tensor, big: int) -> torch.Tensor:
    """Min over each pixel's 3x3 neighbourhood of (B, H, W) labels, the
    border padded with ``big``."""
    h, w = labels.shape[-2:]
    pad = F.pad(labels, (1, 1, 1, 1), value=big)
    out = pad[:, 1:h + 1, 1:w + 1]
    for dy in range(3):
        for dx in range(3):
            if dy != 1 or dx != 1:
                out = torch.minimum(out, pad[:, dy:dy + h, dx:dx + w])
    return out


def connected_components(mask: torch.Tensor, max_iters: int = 32) -> torch.Tensor:
    """8-connected components of bool masks (..., H, W) -> int32 labels.

    Background = -1; a component's label is the smallest linear index it
    contains (once the sweeps have converged, as they have for any
    component whose pointer chains 32 sweeps of 12 jumps resolve)."""
    shape = mask.shape
    h, w = shape[-2:]
    n = h * w
    m = mask.reshape(-1, h, w).bool()
    b = m.shape[0]
    idx = torch.arange(n, dtype=torch.long, device=m.device).reshape(1, h, w)
    labels = torch.where(m, idx, n)
    m_flat = m.reshape(b, n)
    for _ in range(max_iters):
        nb = _neighbour_min(torch.where(m, labels, n), n)
        flat = labels.reshape(b, n)
        nbf = torch.where(m_flat, nb.reshape(b, n), n)
        # hook: when a pixel sees a smaller neighbour label, its current
        # root adopts it (scatter-min)
        inside = flat < n
        root = torch.where(inside, flat.clamp(0, n - 1), n - 1)
        flat = flat.scatter_reduce(1, root, torch.where(inside, nbf, n), "amin", include_self=True)
        flat = torch.minimum(flat, nbf)
        for _ in range(JUMPS):
            flat = torch.minimum(flat, torch.where(flat < n, flat.gather(1, flat.clamp(0, n - 1)), n))
        labels = flat.reshape(b, h, w)
    return torch.where(m, labels, -1).to(torch.int32).reshape(shape)


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Pixel count per label id of (..., H, W) labels -> (..., H * W) int32
    (zero for ids that are not component roots)."""
    h, w = labels.shape[-2:]
    n = h * w
    flat = labels.reshape(-1, n).long().clamp(-1, n - 1)
    valid = flat >= 0
    sizes = torch.zeros(flat.shape, dtype=torch.int32, device=labels.device)
    sizes = sizes.scatter_add(1, torch.where(valid, flat, 0), valid.to(torch.int32))
    return sizes.reshape(labels.shape[:-2] + (n,))


def _edt_1d(f: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Exact 1D squared-EDT min-plus along the last dim: d[i] = min_j (i -
    j)^2 + f[j], blocked over j."""
    n = f.shape[-1]
    i = torch.arange(n, dtype=torch.float32, device=f.device)
    out = torch.full(f.shape, torch.inf, dtype=torch.float32, device=f.device)
    for j0 in range(0, n, chunk):
        width = min(chunk, n - j0)
        j = j0 + torch.arange(width, dtype=torch.float32, device=f.device)
        d2 = (i[:, None] - j[None, :]) ** 2
        cand = f[..., j0:j0 + width][..., None, :] + d2
        out = torch.minimum(out, cand.amin(dim=-1))
    return out


def edt(mask: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Squared Euclidean distance of each True pixel of an (H, W) mask to
    the nearest False one (``cv2.distanceTransform(DIST_L2) ** 2``) ->
    float32 (H, W)."""
    f = torch.where(mask > 0, 1e12, 0.0).float()
    d = _edt_1d(f, chunk)             # along rows
    return _edt_1d(d.T, chunk).T      # along columns


def sample_point_from_error_region(
    pred_mask: torch.Tensor, gt_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interactive-refinement point selection (``sam3_tracker_utils.py``):
    the pixel deepest inside the error mask, the false negatives when they
    are at least as many as the false positives, else the false positives.
    The JAX function's ``rng`` argument is unused there, so this takes none.

    Returns ((y, x) int32, is_positive bool): positive when the error is a
    false negative (missed foreground). Ties of the EDT go to the lowest
    linear index, taken as the smallest index among the maxima (not left to
    ``argmax``'s order on the device); with no error pixel, (0, 0) and True."""
    fn = (gt_mask > 0) & (pred_mask <= 0)
    fp = (gt_mask <= 0) & (pred_mask > 0)
    use_fn = fn.sum() >= fp.sum()
    err = torch.where(use_fn, fn, fp)
    d = edt(err).reshape(-1)
    idx = torch.arange(d.numel(), device=d.device)
    flat = torch.where(d == d.max(), idx, d.numel()).amin()
    w = err.shape[-1]
    return torch.stack([flat // w, flat % w]).to(torch.int32), use_fn
