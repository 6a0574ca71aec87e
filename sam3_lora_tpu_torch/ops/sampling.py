"""Bilinear sampling by hand (port of ``sam3_lora_tpu/ops/sampling.py``):
``grid_sample`` (F.grid_sample, bilinear, zero padding, align_corners=False)
and ``roi_align`` (torchvision.ops.roi_align with its defaults), written out
as gathers since the port has no torchvision."""

from __future__ import annotations

import torch


def _gather(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """img (N, C, H, W), integer coords (N, ...) -> (N, C, ...)."""
    n, c, h, w = img.shape
    flat = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
    out = torch.gather(img.reshape(n, c, h * w), 2, flat)
    return out.reshape(n, c, *xi.shape[1:])


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img (N, C, H, W); grid (N, Ho, Wo, 2) in [-1, 1], (x, y) order.
    Returns (N, C, Ho, Wo)."""
    n, c, h, w = img.shape
    x = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    y = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    def tap(xi, yi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        vals = _gather(img, xi.clamp(0, w - 1).long(), yi.clamp(0, h - 1).long())
        return torch.where(valid[:, None], vals, torch.zeros_like(vals))

    return (
        tap(x0, y0) * (wx0 * wy0)[:, None]
        + tap(x0 + 1, y0) * (wx1 * wy0)[:, None]
        + tap(x0, y0 + 1) * (wx0 * wy1)[:, None]
        + tap(x0 + 1, y0 + 1) * (wx1 * wy1)[:, None]
    )


def _roi_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torchvision roi_align's bilinear taps: zero only when more than one
    pixel outside the image, else clamp into it and lerp."""
    n, c, h, w = img.shape
    invalid = (x < -1.0) | (x > w) | (y < -1.0) | (y > h)
    x = x.clamp(min=0.0)
    y = y.clamp(min=0.0)
    x_low = torch.floor(x).clamp(max=w - 1)
    y_low = torch.floor(y).clamp(max=h - 1)
    x_eff = torch.where(x >= w - 1, x_low, x)
    y_eff = torch.where(y >= h - 1, y_low, y)
    x_high = (x_low + 1).clamp(max=w - 1)
    y_high = (y_low + 1).clamp(max=h - 1)
    lx, ly = x_eff - x_low, y_eff - y_low
    hx, hy = 1.0 - lx, 1.0 - ly
    xl, xh, yl, yh = x_low.long(), x_high.long(), y_low.long(), y_high.long()
    out = (
        _gather(img, xl, yl) * (hx * hy)[:, None]
        + _gather(img, xh, yl) * (lx * hy)[:, None]
        + _gather(img, xl, yh) * (hx * ly)[:, None]
        + _gather(img, xh, yh) * (lx * ly)[:, None]
    )
    return torch.where(invalid[:, None], torch.zeros_like(out), out)


def roi_align(
    img: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int,
    sampling_ratio: int = -1,
    aligned: bool = False,
    max_samples: int = 16,
) -> torch.Tensor:
    """torchvision.ops.roi_align: img (N, C, H, W), boxes (N, R, 4) xyxy in
    feature-pixel coords -> (N, R, C, output_size, output_size).

    sampling_ratio=-1 takes ceil(bin) samples per bin for each ROI, realized
    with ``max_samples`` slots and a mask over the unused ones."""
    n, c, h, w = img.shape
    r = boxes.shape[1]
    p = output_size
    smax = sampling_ratio if sampling_ratio > 0 else max_samples
    offset = 0.5 if aligned else 0.0
    dev = img.device
    i = torch.arange(p, dtype=torch.float32, device=dev)
    t = torch.arange(smax, dtype=torch.float32, device=dev)

    x0 = boxes[..., 0] - offset  # (N, R)
    y0 = boxes[..., 1] - offset
    rw = boxes[..., 2] - boxes[..., 0]
    rh = boxes[..., 3] - boxes[..., 1]
    if not aligned:  # torchvision forces >= 1px ROIs when not aligned
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    bin_w, bin_h = rw / p, rh / p
    if sampling_ratio > 0:
        kw = kh = torch.full_like(bin_w, float(sampling_ratio))
    else:
        kw = torch.ceil(bin_w).clamp(1.0, smax)
        kh = torch.ceil(bin_h).clamp(1.0, smax)
    ex = lambda a: a[..., None, None]  # noqa: E731  (N, R) -> (N, R, 1, 1)
    # sample coords (N, R, P, S): x0 + bin * (i + (t + 0.5) / k)
    xs = ex(x0) + ex(bin_w) * (i[:, None] + (t[None, :] + 0.5) / ex(kw))
    ys = ex(y0) + ex(bin_h) * (i[:, None] + (t[None, :] + 0.5) / ex(kh))
    ps = p * smax
    xx = xs.reshape(n, r, 1, ps).expand(n, r, ps, ps).reshape(n, r * ps * ps)
    yy = ys.reshape(n, r, ps, 1).expand(n, r, ps, ps).reshape(n, r * ps * ps)
    vals = _roi_bilinear(img, xx, yy).reshape(n, c, r, p, smax, p, smax)
    mx = (t[None, None, :] < kw[..., None]).float()  # (N, R, S)
    my = (t[None, None, :] < kh[..., None]).float()
    wgt = my[:, :, None, :, None, None] * mx[:, :, None, None, None, :]  # (N,R,1,S,1,S)
    vals = vals.permute(0, 2, 1, 3, 4, 5, 6) * wgt[:, :, :, None]
    vals = vals.sum(dim=(4, 6))  # (N, R, C, P, P)
    return vals / (kw * kh)[..., None, None, None]
