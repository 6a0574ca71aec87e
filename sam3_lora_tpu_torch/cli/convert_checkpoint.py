"""Convert a reference SAM3 PyTorch checkpoint into the flat base ``.npz``
that ``utils/checkpoint.py::load_base_checkpoint`` loads, with no JAX (port
of ``scripts/convert_checkpoint.py``).

The key mapping and layout transforms (``SKIP_PATTERNS``, ``RENAMES``,
``_ref_to_ours_key``, ``convert_tensor``, ``vit_scan_map``,
``_stack_scanned``, ``convert_state_dict``) are the script's, statement for
statement: reference keys lose ``detector.``, the decoder's boxRPB MLPs move
under ``rpb.``, per-block RoPE tables and the pixel decoder's unused third
stage are skipped, Linear weights are transposed to ``kernel`` (in, out),
Conv2d weights permuted to (kh, kw, in, out), MHA ``in_proj_weight``
transposed. The target names and shapes come from the port's model
(``utils/checkpoint.py::base_param_shapes``, built on the ``meta`` device,
so no weight is allocated) in place of the script's JAX ``eval_shape``.

A bf16 tensor in the checkpoint is widened to fp32 before conversion (numpy
has no bf16; the values are exact).

Usage:
    python -m sam3_lora_tpu_torch.cli.convert_checkpoint --torch-ckpt sam3.pt --out base.npz [--tiny]
    # or, given a model and a state dict: load_reference_state_dict(model, sd)
"""

from __future__ import annotations

import argparse
import fnmatch
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

# reference keys with no destination (buffers / dead params)
SKIP_PATTERNS = (
    "*.attn.freqs_cis",
    "segmentation_head.pixel_decoder.conv_layers.2.*",
    "segmentation_head.pixel_decoder.norms.2.*",
)

# reference prefix -> our prefix
RENAMES = (
    ("transformer.decoder.boxRPB_embed_x.", "transformer.decoder.rpb.boxRPB_embed_x."),
    ("transformer.decoder.boxRPB_embed_y.", "transformer.decoder.rpb.boxRPB_embed_y."),
)


def _ref_to_ours_key(ref_key: str) -> str:
    k = ref_key
    if k.startswith("detector."):
        k = k[len("detector."):]
    for src, dst in RENAMES:
        if k.startswith(src):
            k = dst + k[len(src):]
    return k


def convert_tensor(our_key: str, our_shape: Tuple[int, ...], t: np.ndarray) -> np.ndarray:
    """Apply the layout transform that maps the torch tensor onto our param."""
    leaf = our_key.rsplit(".", 1)[-1]
    if leaf == "kernel":
        if t.ndim == 2:
            t = t.T
        elif t.ndim == 4:
            t = t.transpose(2, 3, 1, 0)  # (O,I,kh,kw) -> (kh,kw,I,O)
        else:
            raise ValueError(f"unexpected kernel ndim {t.ndim} for {our_key}")
    elif leaf == "in_proj_weight":
        t = t.T  # (3d, d) -> (d, 3d)
    elif leaf == "text_projection" and tuple(t.shape) != tuple(our_shape):
        t = t.T
    if tuple(t.shape) != tuple(our_shape):
        raise ValueError(
            f"{our_key}: converted shape {t.shape} != model shape {our_shape}"
        )
    return t


def vit_scan_map(cfg) -> Dict[str, Tuple[int, ...]]:
    """{scan module name: (block indices)} for ModelConfig.vit_scan_blocks
    (the windowed runs between global blocks — see models/vit.py)."""
    groups: Dict[str, Tuple[int, ...]] = {}
    run, g = [], 0
    for i in range(cfg.vit_depth):
        if i in cfg.vit_global_blocks:
            if run:
                groups[f"scan_blocks_{g}"] = tuple(run)
            g += 1
            run = []
        else:
            run.append(i)
    if run:
        groups[f"scan_blocks_{g}"] = tuple(run)
    return groups


def _stack_scanned(our_key, our_shape, torch_sd, scan_map):
    """Resolve '...trunk.scan_blocks_g.block.REST' by stacking the per-block
    reference tensors blocks.{i}.REST along a new leading axis."""
    import re

    m = re.match(r"(.*trunk\.)(scan_blocks_\d+)\.block\.(.*)$", our_key)
    if not m or m.group(2) not in scan_map:
        return None, []
    prefix, gname, rest = m.groups()
    ref_rest = rest
    if ref_rest.endswith(".kernel"):
        ref_rest = ref_rest[: -len(".kernel")] + ".weight"
    slot_shape = tuple(our_shape[1:])
    slabs, used = [], []
    for i in scan_map[gname]:
        rk = f"{prefix}blocks.{i}.{ref_rest}"
        if rk not in torch_sd:
            return None, []
        slabs.append(convert_tensor(our_key, slot_shape, np.asarray(torch_sd[rk])))
        used.append(rk)
    return np.stack(slabs), used


def convert_state_dict(
    torch_sd: Dict[str, "np.ndarray"],
    our_shapes: Dict[str, Tuple[int, ...]],
    strict: bool = True,
    scan_map: Optional[Dict[str, Tuple[int, ...]]] = None,
) -> Dict[str, np.ndarray]:
    """torch state dict (numpy values) -> flat dict keyed by our param names.

    ``our_shapes``: {'.'-joined flax path: shape} for all non-adapter params.
    ``scan_map``: vit_scan_map(cfg) when the model uses scanned ViT blocks.
    """
    out: Dict[str, np.ndarray] = {}
    consumed = set()
    unmatched = []

    if scan_map:
        for our_key, shape in our_shapes.items():
            stacked, used = _stack_scanned(our_key, shape, torch_sd, scan_map)
            if stacked is not None:
                out[our_key] = stacked
                consumed.update(used)

    for ref_key, val in torch_sd.items():
        if ref_key in consumed:
            continue
        if any(fnmatch.fnmatch(ref_key, pat) for pat in SKIP_PATTERNS):
            continue
        our_key = _ref_to_ours_key(ref_key)
        want = None
        if our_key in our_shapes:
            want = our_key
        elif our_key.endswith(".weight"):
            cand = our_key[: -len(".weight")] + ".kernel"
            if cand in our_shapes:
                want = cand
        if want is None:
            unmatched.append(ref_key)
            continue
        arr = np.asarray(val)
        out[want] = convert_tensor(want, our_shapes[want], arr)
    missing = set(our_shapes) - set(out)
    if strict and unmatched:
        raise KeyError(
            f"{len(unmatched)} reference tensors had no destination "
            f"(first: {unmatched[:5]})"
        )
    if strict and missing:
        raise KeyError(
            f"{len(missing)} model params not covered by checkpoint "
            f"(first: {sorted(missing)[:5]})"
        )
    return out


def state_dict_arrays(sd: Mapping) -> Dict[str, np.ndarray]:
    """A reference state dict (or a checkpoint holding one under ``"model"``)
    -> numpy arrays by key, bf16 widened to fp32; non-tensor entries are
    dropped, as the script drops them."""
    import torch

    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        elif hasattr(v, "numpy"):
            out[k] = v.numpy()
    return out


def convert_for_model(model, sd: Mapping) -> Dict[str, np.ndarray]:
    """A reference state dict -> the flat JAX-named arrays of ``model``'s
    base (scanned as its config scans), strictly: every reference tensor
    has a destination and every base parameter a source."""
    from ..utils.checkpoint import base_param_shapes

    cfg = model.spec.model
    return convert_state_dict(state_dict_arrays(sd), base_param_shapes(model),
                              scan_map=vit_scan_map(cfg) if cfg.vit_scan_blocks else None)


def load_reference_state_dict(model, sd: Mapping) -> int:
    """Read a reference SAM3 state dict (or a checkpoint dict holding one)
    into the port's model: convert, then ``load_jax_params``. Returns the
    number of tensors loaded."""
    from ..utils.checkpoint import load_jax_params

    return load_jax_params(model, convert_for_model(model, sd))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-ckpt", required=True, help="path to .pt/.pth state dict")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--tiny", action="store_true", help="use the tiny test config")
    args = ap.parse_args(argv)

    import torch

    from ..config import ModelConfig, tiny_model_config
    from ..models import build_sam3_image_model

    sd = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    mc = tiny_model_config() if args.tiny else ModelConfig()
    out = convert_for_model(build_sam3_image_model(mc, device="meta"), sd)
    np.savez(args.out, **out)
    print(f"converted {len(out)} tensors -> {args.out}")


if __name__ == "__main__":
    main()
