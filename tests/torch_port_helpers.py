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
