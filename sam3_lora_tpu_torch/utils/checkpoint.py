"""Weight bridge from the JAX package's flat checkpoints.

The JAX package saves parameters as a flat ``.npz`` whose keys are the
'.'-joined Flax paths (``sam3_lora_tpu/utils/checkpoint.py``). The port's
module tree carries the same names, so the bridge is a per-leaf layout
change:

* Linear ``kernel`` (in, out) -> ``weight`` (out, in);
* Conv ``kernel`` (kh, kw, in, out), the patch embed's (p, p, c, D)
  included -> ``weight`` (out, in, kh, kw);
* MHA ``in_proj_weight`` (d, 3d) -> (3d, d);
* ``lora_a`` (in, r) -> (r, in), ``lora_b`` (r, out) -> (out, r);
* the int8 tier's ``kernel_scale`` (1, out) -> ``weight_scale`` (out,), and
  an int8 ``kernel`` (in, out), as ``prequantize_base`` leaves it, -> an
  int8 ``weight`` (out, in);
* the scanned ViT groups ``scan_blocks_{g}.block.*`` (stacked on a leading
  axis) -> ``blocks.{i}.*``, with the group map of the JAX ViT
  (``stack_scanned`` goes the other way, for saving adapters);
* everything else (norms, embeddings, ``pos_embed``, the transposed-conv
  ``weight`` already in torch layout) as it is.

bf16 leaves (``param_dtype="bfloat16"`` storage) arrive as ``ml_dtypes``
bfloat16 arrays in memory, or as 2-byte void arrays from an ``.npz`` (numpy
keeps the bits but not the type); both become bf16 tensors, bit for bit.

A JAX param tree (the nested dict of a Flax ``init``, e.g. a ``TrackerCore``'s,
numpy or jax arrays) is flattened to the same '.'-joined names
(``flatten_tree``) and loads the same way (``load_jax_tree``). The raw
parameters of the SAM heads and the tracker (the Gaussian matrix of the
prompt encoder, ``no_mem_embed``, ``maskmem_tpos_enc``, the layer scales,
the embedding tables) keep their layout, as do the transposed convs'
``weight`` leaves.

``load_jax_params`` then folds the rotate-half column permutation of the ViT
qkv projection (which the JAX module applies at every call) into the q/k
output channels of ``weight``, ``bias``, ``lora_b`` and ``weight_scale``,
once, at load. An int8 tensor replaces its parameter (the layer then runs
the prequantized int8 route); a float one is copied in the parameter's dtype.

``save_base_checkpoint`` goes the other way: the model's base parameters in
the JAX names, layout, channel order and (scanned) grouping, a flat ``.npz``
that JAX's ``load_base_checkpoint`` loads strictly. It writes bf16 leaves
widened to fp32 (exact): numpy keeps bf16 only as 2-byte void, which JAX's
loader cannot cast, while both loaders take the fp32 values into a bf16
parameter bit for bit.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import Conv2d, LoRALinear

_SCAN = re.compile(r"^(?:(.*)\.)?scan_blocks_(\d+)\.block\.(.*)$")


def _unstack_scanned(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Group g of the JAX ViT holds the windowed run that ends just before
    its global block (the g-th in order); a trailing group with no global
    block starts after the last one."""
    groups: Dict[str, Dict[int, int]] = {}
    for name, arr in flat.items():
        m = _SCAN.match(name)
        if m:
            prefix = f"{m.group(1)}." if m.group(1) else ""
            groups.setdefault(prefix, {})[int(m.group(2))] = arr.shape[0]
    if not groups:
        return dict(flat)
    out = {}
    starts = {}
    for prefix, lengths in groups.items():
        glob = sorted({
            int(m.group(1)) for name in flat
            for m in [re.match(re.escape(prefix) + r"blocks\.(\d+)\.", name)] if m
        })
        for g, n in lengths.items():
            start = glob[g] - n if g < len(glob) else (glob[-1] + 1 if glob else 0)
            starts[(prefix, g)] = start
    for name, arr in flat.items():
        m = _SCAN.match(name)
        if not m:
            out[name] = arr
            continue
        prefix = f"{m.group(1)}." if m.group(1) else ""
        g, rest = int(m.group(2)), m.group(3)
        start = starts[(prefix, g)]
        for j in range(arr.shape[0]):
            out[f"{prefix}blocks.{start + j}.{rest}"] = arr[j]
    return out


_TRUNK_BLOCK = re.compile(r"^(.*trunk\.)blocks\.(\d+)\.(.*)$")


def scan_groups(cfg):
    """The JAX ViT's scanned groups: (windowed run, following global block or
    None) pairs, e.g. depth 32 / globals (7, 15, 23, 31) -> [((0..6), 7),
    ((8..14), 15), ...]."""
    groups, run = [], []
    for i in range(cfg.vit_depth):
        if i in cfg.vit_global_blocks:
            groups.append((tuple(run), i))
            run = []
        else:
            run.append(i)
    if run:
        groups.append((tuple(run), None))
    return groups


def stack_scanned(flat: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """Flat JAX-layout arrays named ``...trunk.blocks.{i}.*`` -> the scanned
    naming of the JAX ViT (``...trunk.scan_blocks_{g}.block.*``, the windowed
    run of group g stacked on a leading axis); global blocks keep their
    names."""
    where = {i: (g, j) for g, (run, _) in enumerate(scan_groups(cfg)) for j, i in enumerate(run)}
    out, stacks = {}, {}
    for name, arr in flat.items():
        m = _TRUNK_BLOCK.match(name)
        if m is None or int(m.group(2)) not in where:
            out[name] = arr
            continue
        g, j = where[int(m.group(2))]
        stacks.setdefault(f"{m.group(1)}scan_blocks_{g}.block.{m.group(3)}", {})[j] = arr
    for name, parts in stacks.items():
        out[name] = np.stack([parts[j] for j in sorted(parts)])
    return out


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX flat params (``lora_a``/``lora_b`` included) -> tensors keyed by
    the port's ``state_dict`` names, in torch layout. The qkv permutation is
    not applied here (it needs the module; see ``load_jax_params``)."""
    out = {}
    for name, arr in _unstack_scanned(flat).items():
        arr = np.asarray(arr)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            name = name[: -len("kernel")] + "weight"
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel_scale":
            name = name[: -len("kernel_scale")] + "weight_scale"
            arr = arr.reshape(-1)
        elif leaf in ("in_proj_weight", "lora_a", "lora_b"):
            arr = arr.T
        out[name] = _tensor(arr)
    return out


def _fold_out_perm(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    for name, m in model.named_modules():
        if isinstance(m, LoRALinear) and m.out_perm is not None:
            for leaf in ("weight", "bias", "lora_b", "weight_scale"):
                key = f"{name}.{leaf}"
                if key in tensors:  # rows are the output channels
                    tensors[key] = tensors[key][m.out_perm]


def load_tensors(model: nn.Module, tensors: Dict[str, torch.Tensor], strict: bool = True,
                 optional: Sequence[str] = ()) -> int:
    """Copy torch-layout tensors (JAX channel order) into the model. Every
    key must name a parameter; with ``strict`` every non-adapter parameter
    must be given, but those under a prefix in ``optional``. Returns the
    number copied."""
    tensors = dict(tensors)
    _fold_out_perm(model, tensors)
    params = dict(model.named_parameters())
    extra = sorted(set(tensors) - set(params))
    if extra:
        raise KeyError(f"{len(extra)} checkpoint keys not in model (first: {extra[:5]})")
    # adapters, and the int8 tier's scales (unused until prequantize_model
    # fills them), may be absent from a base checkpoint
    missing = sorted(
        k for k in set(params) - set(tensors)
        if not k.endswith(("lora_a", "lora_b", "weight_scale"))
        and not k.startswith(tuple(optional))
    )
    if missing and strict:
        raise KeyError(f"{len(missing)} model params missing from checkpoint (first: {missing[:5]})")
    with torch.no_grad():
        for k, t in tensors.items():
            p = params[k]
            if tuple(p.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {k}: ckpt {tuple(t.shape)} vs model {tuple(p.shape)}")
            if torch.int8 in (t.dtype, p.dtype) and t.dtype != p.dtype:
                owner, _, leaf = k.rpartition(".")
                owner = model.get_submodule(owner)
                dtype = t.dtype if t.dtype == torch.int8 else owner.spec.param_dtype
                setattr(owner, leaf, nn.Parameter(t.to(device=p.device, dtype=dtype),
                                                  requires_grad=False))
            else:
                p.copy_(t.to(dtype=p.dtype, device=p.device))
    return len(tensors)


def load_jax_params(model: nn.Module, flat: Dict[str, np.ndarray], strict: bool = True) -> int:
    """Load JAX flat params (an init, a base checkpoint or both with
    adapters) into the port's model; returns the number of tensors loaded."""
    return load_tensors(model, params_from_jax(flat), strict=strict)


def jax_axes(module: nn.Module, leaf: str, ndim: int) -> tuple:
    """The torch axis of each axis of the JAX layout of parameter ``leaf``
    of ``module`` (the inverse of ``params_from_jax``'s transposes): a
    linear ``kernel`` (in, out) is ``weight`` (out, in), a conv ``kernel``
    (kh, kw, in, out) is (out, in, kh, kw), ``in_proj_weight``, ``lora_a``
    and ``lora_b`` are transposed, the rest keep their layout."""
    if leaf in ("in_proj_weight", "lora_a", "lora_b") or (
            leaf == "weight" and isinstance(module, LoRALinear)):
        return (1, 0)
    if leaf == "weight" and isinstance(module, Conv2d):
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def base_params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """Every base parameter (not the adapters, not the int8 tier's
    ``weight_scale``) as flat JAX-named numpy arrays: ``weight`` back to
    ``kernel`` where the bridge renamed it, the transposes undone, the qkv
    permutation unfolded, the scanned ViT groups stacked when the config
    scans them, bf16 widened to fp32. A prequantized (int8) weight raises:
    save the float base, and quantize after loading."""
    out = {}
    for mod_name, module in model.named_modules():
        unperm = None
        if isinstance(module, LoRALinear) and module.out_perm is not None:
            unperm = torch.empty_like(module.out_perm)
            unperm[module.out_perm] = torch.arange(len(module.out_perm))
        for leaf, p in module.named_parameters(recurse=False):
            if leaf in ("lora_a", "lora_b", "weight_scale"):
                continue
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if p.dtype == torch.int8:
                raise ValueError(f"{name} is int8 (prequantized); save the model before "
                                 "prequantize_model")
            t = p.detach().cpu()
            if unperm is not None and leaf in ("weight", "bias"):
                t = t[unperm]  # rows are the output channels
            t = t.permute(jax_axes(module, leaf, t.ndim))
            if leaf == "weight" and isinstance(module, (LoRALinear, Conv2d)):
                name = name[: -len("weight")] + "kernel"
            out[name] = np.ascontiguousarray(t.float().numpy() if t.dtype == torch.bfloat16
                                             else t.numpy())
    cfg = model.spec.model
    return stack_scanned(out, cfg) if cfg.vit_scan_blocks else out


def save_base_checkpoint(model: nn.Module, path: str) -> int:
    """Write the model's base parameters as the JAX package's flat base
    checkpoint ``.npz`` (``base_params_to_jax``); returns the number of
    arrays written."""
    out = base_params_to_jax(model)
    np.savez(path, **out)
    return len(out)


def load_base_checkpoint(model: nn.Module, path: str, strict: bool = True) -> int:
    """Load a converted base checkpoint ``.npz`` written by the JAX package."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return load_jax_params(model, flat, strict=strict)


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested param dict (a Flax ``init``'s ``params``) -> flat '.'-joined
    numpy arrays, the JAX package's checkpoint naming."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def load_jax_tree(module: nn.Module, tree: Mapping[str, Any], optional: Sequence[str] = ()) -> int:
    """Load a JAX param tree (e.g. a ``TrackerCore``'s) into the port's
    module, strictly but for the prefixes in ``optional``."""
    return load_tensors(module, params_from_jax(flatten_tree(tree)), optional=optional)
