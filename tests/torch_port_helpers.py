"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX side is built with ``jax.eval_shape`` (no random-init compile) and
filled with numpy random values from a seed; the same flat '.'-joined dict
goes through the port's weight bridge, so both packages run the same
weights.
"""

from __future__ import annotations

import jax
import numpy as np
import torch
from flax import traverse_util


def _fill(name: str, shape, rng: np.random.RandomState) -> np.ndarray:
    parts = name.split(".")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    is_norm = "norm" in owner or owner.startswith("ln")
    if is_norm and leaf == "weight":
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if leaf == "bias" or len(shape) <= 1:
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if owner == "reference_points":
        return rng.standard_normal(shape).astype(np.float32)
    fan = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-2]
    scale = (0.5 if leaf == "lora_b" else 1.0) / np.sqrt(max(fan, 1))
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def param_specs(module, *args, **kwargs):
    """The parameters of ``module.init`` as (path tuple, shape) pairs, in
    the order ``fill_params`` draws them."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, **kwargs)
    )["params"]
    return [(path, tuple(s.shape)) for path, s in sorted(traverse_util.flatten_dict(shapes).items())]


def fill_params(specs, seed: int = 0):
    """(path tuple, shape) pairs -> flat '.'-joined numpy dict of seeded
    random values (numpy only: the port's tests rebuild JAX weights with it)."""
    rng = np.random.RandomState(seed)
    return {".".join(path): _fill(".".join(path), shape, rng) for path, shape in specs}


def random_jax_params(module, *args, seed: int = 0, **kwargs):
    """-> (params pytree for ``module.apply``, flat '.'-joined numpy dict)."""
    specs = param_specs(module, *args, **kwargs)
    flat = fill_params(specs, seed)
    params = traverse_util.unflatten_dict(
        {path: jax.numpy.asarray(flat[".".join(path)]) for path, _ in specs})
    return params, flat


def jax_apply(module, params, *args, **kwargs):
    """``module.apply`` under ``jax.jit`` (one compile instead of one per
    eager op); non-array arguments (ints, tuples of ints, flags) are closed
    over as constants."""
    leaves, treedef = jax.tree_util.tree_flatten((args, kwargs))
    is_arr = [isinstance(x, (jax.Array, np.ndarray)) for x in leaves]

    def run(p, arrays):
        it = iter(arrays)
        full = [next(it) if a else x for x, a in zip(leaves, is_arr)]
        a, kw = jax.tree_util.tree_unflatten(treedef, full)
        return module.apply({"params": p}, *a, **kw)

    return jax.jit(run)(params, [x for x, a in zip(leaves, is_arr) if a])


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(port, ref, rtol: float, atol: float, name: str = "") -> None:
    np.testing.assert_allclose(to_np(port), to_np(ref), rtol=rtol, atol=atol, err_msg=name)


def save_reference(path: str, specs, arrays) -> str:
    """Store a JAX reference: the parameter specs it was drawn at (as
    ``fill_params`` takes them) and its result arrays."""
    import json

    np.savez(path, params=json.dumps([[".".join(p), list(s)] for p, s in specs]),
             **{k: np.asarray(v) for k, v in arrays.items()})
    return path


def load_reference(path: str):
    """-> (specs, {name: array}) as ``save_reference`` stored them."""
    import json

    with np.load(path) as data:
        specs = [(tuple(n.split(".")), tuple(s)) for n, s in json.loads(str(data["params"]))]
        return specs, {k: data[k] for k in data.files if k != "params"}


def nested(flat):
    """A flat '.'-joined dict -> the nested dict of a Flax param tree (split
    at every '.'; ``utils/checkpoint.py::flatten_tree`` joins it back)."""
    out = {}
    for name, arr in flat.items():
        *head, leaf = name.split(".")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return out


TINY_TARGETS = ("qkv", "fc1", "fc2", "linear1", "linear2")  # the processors' adapters


def jax_tiny_processor():
    """-> (the JAX package's ``Sam3Processor`` on the tiny config with
    adapters on ``TINY_TARGETS`` and weights filled from numpy seed 0, its
    parameter specs)."""
    import jax.numpy as jnp
    import pytest
    from flax import traverse_util

    from sam3_lora_tpu import processor as jax_processor
    from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
    from sam3_lora_tpu.models import build_sam3_image_model
    from sam3_lora_tpu.models.geometry import GeoPrompt
    from sam3_lora_tpu.models.sam3_image import Batch

    cfg = tiny_model_config()
    lora = LoRAConfig(rank=4, alpha=8.0, target_modules=TINY_TARGETS)
    r = cfg.img_size
    batch = Batch(images=jnp.zeros((1, 3, r, r)),
                  token_ids=jnp.zeros((1, cfg.text_context_length), jnp.int32),
                  img_ids=jnp.zeros((1,), jnp.int32), geo=GeoPrompt.empty(1, cfg.max_prompt_boxes))
    specs = param_specs(build_sam3_image_model(cfg, lora=lora), batch, train=False)
    flat = fill_params(specs)
    params = traverse_util.unflatten_dict({p: jnp.asarray(flat[".".join(p)]) for p, _ in specs})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_processor, "init_model", lambda model, key: params)
        return jax_processor.Sam3Processor(cfg, lora), specs


def port_tiny_processor(specs):
    """The port's ``Sam3Processor`` on the CPU with ``jax_tiny_processor``'s
    weights (``specs`` as it returned them)."""
    from sam3_lora_tpu_torch import config as tc
    from sam3_lora_tpu_torch.processor import Sam3Processor
    from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

    proc = Sam3Processor(tc.tiny_model_config(),
                         tc.LoRAConfig(rank=4, alpha=8.0, target_modules=TINY_TARGETS), device="cpu")
    load_jax_params(proc.model, fill_params(specs))
    return proc


def jax_video_tracker(proc, num_maskmem: int, max_obj_ptrs: int, seed: int = 1):
    """-> (a JAX ``TrackerCore`` param tree for the video tier, as the JAX
    ``VideoGrounder``'s own init traces it, filled from numpy ``seed``; its
    specs)."""
    import jax.numpy as jnp
    from flax import traverse_util

    from sam3_lora_tpu import video as jvideo
    from sam3_lora_tpu.models.layers import Spec
    from sam3_lora_tpu.models.tracker import TrackerCore

    cfg = proc.cfg
    d, fh = cfg.d_model, cfg.img_size // cfg.patch_size
    core = TrackerCore(Spec(model=cfg, lora=None), d_model=d, mem_dim=max(d // 4, 8),
                       num_maskmem=num_maskmem, max_obj_ptrs=max_obj_ptrs, feat_sizes=(fh, fh))

    class Grounder:  # what the init tracer reads of a grounder
        feat_hw, mem_dim = (fh, fh), max(d // 4, 8)

    Grounder.proc = proc
    specs = param_specs(core, method=lambda m: jvideo._init_tracker_core(m, Grounder, d))
    flat = fill_params(specs, seed)
    return traverse_util.unflatten_dict({p: jnp.asarray(flat[".".join(p)]) for p, _ in specs}), specs


def code_of(module) -> str:
    """A module's syntax tree without its docstrings (a copy's code equals
    the original's when these are equal)."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def count_card_entries(monkeypatch):
    """On the CPU, take the card's attention routes and count what the
    card's kernels count: each entry's forward computations (not a remat
    replay that takes a kept result back) on ``entry.launches``, their
    rotation passes on ``rope_cuda.launches`` and the backwards on
    ``entry.bwd_launches`` (the counters ``chip_smoke.counts`` reads,
    zeroed by ``chip_smoke.reset_counts``)."""
    from sam3_lora_tpu_torch.ops import attention_kernel as ak
    from sam3_lora_tpu_torch.ops import window_attention as wa

    monkeypatch.setattr(wa, "_FORCE_INTERPRET", True)
    stack = []

    def on_entry(fn):
        def wrapped(entry, *a, **k):
            stack.append(entry)
            try:
                return fn(entry, *a, **k)
            finally:
                stack.pop()
        return wrapped

    def forward(q, k, v, scale, cos=None, sin=None, _plain=ak.attention_plain):
        if stack:
            stack[-1].launches += 1
            ak.rope_cuda.launches += cos is not None
        return _plain(q, k, v, scale, cos, sin)

    def backward(*a, _plain=ak.attention_bwd_plain, **k):
        if stack:
            stack[-1].bwd_launches += 1
        return _plain(*a, **k)

    monkeypatch.setattr(ak, "_forward", on_entry(ak._forward))
    monkeypatch.setattr(ak, "_backward", on_entry(ak._backward))
    monkeypatch.setattr(ak, "attention_plain", forward)
    monkeypatch.setattr(ak, "attention_bwd_plain", backward)
