"""One rank of the sharded-base tests (``tests/test_torch_fsdp.py``): the
port with its frozen base placed by ``parallel.shard_params_`` in a
2-process gloo group on the CPU, against the same work unsharded in the
same process.

    MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> WORLD_SIZE=2 RANK=<r> \\
        python tests/torch_fsdp_worker.py <dir> <part> [<part> ...]

runs each part (``PARTS``) and writes what the rank saw to
``<dir>/<part>_rank<r>.pt``. ``cases``: one case per module type that holds
a sharded leaf (``CASES``),
each built at a size where ``param_shardings(..., shard_base=True)`` splits
it: the output, the input's and the adapters' gradients, the gathered
leaves and the rank's slices, the gathers in the forward and the backward,
and the gathered tensors alive between the forward and the backward.
``writers``: ``save_base_checkpoint``, ``merge_lora_into_base`` and
``Trainer.save_state`` on a sharded tiny model. ``quant``:
``prequantize_model`` of a sharded tiny model against JAX's. ``plain``,
``jax_rule``, ``every_leaf``: the tiny config's training step in the int8
tier at accumulation 2 on the batch of
``tests/data/torch_ref_train_int8_fsdp.npz`` (the rank's half, by image, as
JAX's two microbatches are spread over the data axis), unsharded, sharded by
JAX's rule and with every base leaf sharded.
"""

from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from sam3_lora_tpu_torch.config import LoRAConfig, TrainConfig, tiny_model_config  # noqa: E402
from sam3_lora_tpu_torch.models import Batch, GeoPrompt, Targets, build_sam3_image_model  # noqa: E402
from sam3_lora_tpu_torch.models.builder import init_model  # noqa: E402
from sam3_lora_tpu_torch.models.layers import Conv2d, LoRALinear, MultiHeadAttention, Spec  # noqa: E402
from sam3_lora_tpu_torch.models.lora import lora_state, merge_lora_into_base, trainable_parameters  # noqa: E402
from sam3_lora_tpu_torch.models.neck import ConvTranspose2x2  # noqa: E402
from sam3_lora_tpu_torch.models.text_encoder import TextTransformer  # noqa: E402
from sam3_lora_tpu_torch.models.vit import ViT  # noqa: E402
from sam3_lora_tpu_torch.ops import gemm_int8  # noqa: E402
from sam3_lora_tpu_torch.ops.quant import prequantize_model  # noqa: E402
from sam3_lora_tpu_torch.parallel import dist_utils, fsdp, multihost  # noqa: E402
from sam3_lora_tpu_torch.parallel.mesh import (  # noqa: E402
    DATA_AXIS, Sharding, make_mesh, param_shardings, shard_batch, shard_params_)
from sam3_lora_tpu_torch.train.losses import LossConfig  # noqa: E402
from sam3_lora_tpu_torch.train.trainer import Trainer, train_step  # noqa: E402
from sam3_lora_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_jax_params, save_base_checkpoint, stack_scanned)

from torch_port_helpers import fill_params  # noqa: E402

DATA = os.path.join(HERE, "data")
QUANT = dict(base_quant="int8", base_quant_min_dim=16)
LORA = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))
ACCUM = 2
# the global batch in the order that gives rank r images 2r, 2r + 1 (its part
# of JAX's first microbatch, rows 0-3) and 4 + 2r, 5 + 2r (of the second)
RANK_ORDER = (0, 1, 4, 5, 2, 3, 6, 7)


def _spec(**overrides) -> Spec:
    return Spec(tiny_model_config(**overrides))


def _linear(in_f, out_f, rank=4, **overrides):
    def build():
        m = LoRALinear(in_f, out_f, _spec(**overrides))
        m.add_adapter(rank, 2.0 * rank)
        return m
    return build, lambda g: (torch.randn(3, 5, in_f, generator=g),)


def _mha():
    return (lambda: MultiHeadAttention(256, 8, _spec()),
            lambda g: tuple(torch.randn(2, 7, 256, generator=g) for _ in range(3)))


def _conv(in_ch, out_ch, k, padding):
    return (lambda: Conv2d(in_ch, out_ch, (k, k), _spec(), padding=padding),
            lambda g: (torch.randn(2, in_ch, 6, 6, generator=g),))


def _conv_transpose():
    return (lambda: ConvTranspose2x2(256, 128, _spec()),
            lambda g: (torch.randn(2, 256, 3, 3, generator=g),))


def _vit():
    # pos_embed (1, 577, 128): 577 is odd, so the rule splits the width, as
    # at the full config; the patch embed and fc1/fc2 are split too, and the
    # windowed block runs under remat
    spec = _spec(vit_dim=128, vit_depth=2, vit_global_blocks=(1,), vit_pretrain_img_size=336)
    return (lambda: ViT(spec), lambda g: (torch.randn(2, 3, 56, 56, generator=g),))


def _text():
    spec = _spec(text_width=256, text_heads=4, text_layers=1, text_proj_dim=256,
                 text_vocab_size=1024)

    def build():
        m = TextTransformer(spec)
        m.transformer.resblocks[0].mlp.c_fc.add_adapter(4, 8.0)
        return m
    return build, lambda g: (torch.randint(1, 1024, (2, 8), generator=g),)


def _fused():
    gemm_int8.GEMM_LORA_FUSED = True
    return _linear(256, 512, rank=8, **QUANT)


# name -> (builder of (module factory, inputs from a generator), int8 tier)
CASES = {
    "linear_dim0": (lambda: _linear(256, 512), False),
    "linear_dim1": (lambda: _linear(512, 256), False),
    "linear_int8_dim1": (lambda: _linear(512, 256, **QUANT), True),
    "linear_int8_bwd_dim0": (lambda: _linear(256, 512, base_quant="int8_bwd",
                                             base_quant_min_dim=16), True),
    "linear_int8_per_call": (lambda: _linear(512, 256, **QUANT), False),
    "linear_int8_fused": (_fused, True),
    "mha": (_mha, False),
    "conv_dim0": (lambda: _conv(64, 256, 3, 1), False),
    "conv_dim1": (lambda: _conv(256, 64, 2, 0), False),
    "conv_transpose": (_conv_transpose, False),
    "vit": (_vit, False),
    "text": (_text, False),
}


def every_leaf(model, mesh):
    """JAX's rule without its size floor: every leaf of two or more dims that
    its module gathers at use, split on its largest axis that divides over
    the data axis."""
    n = mesh.shape[DATA_AXIS]
    out = {}
    for mod_name, module in model.named_modules():
        for leaf in getattr(module, "SHARDED_AT_USE", ()):
            p = getattr(module, leaf)
            dims = [d for d in sorted(range(p.ndim), key=lambda d: -p.shape[d])
                    if p.shape[d] % n == 0]
            if p.ndim >= 2 and dims:
                spec = [None] * p.ndim
                spec[dims[0]] = DATA_AXIS
                out[f"{mod_name}.{leaf}" if mod_name else leaf] = Sharding(mesh, tuple(spec))
    return out


def split_dims(shardings) -> dict:
    return {n: s.spec.index(DATA_AXIS) for n, s in shardings.items() if DATA_AXIS in s.spec}


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def predicted_bytes(plain, dims: dict, n: int) -> int:
    """The rank's parameter bytes by the placement: a split leaf's 1/n."""
    return sum(p.numel() * p.element_size() // (n if name in dims else 1)
               for name, p in plain.named_parameters())


def _owner(model, name):
    owner, _, leaf = name.rpartition(".")
    return (model.get_submodule(owner) if owner else model), leaf


def run_case(name: str, mesh, rank: int) -> dict:
    factory, quant = CASES[name]
    build, inputs = factory()
    try:
        module = build()
        init_model(module, torch.Generator().manual_seed(0))
        ref = copy.deepcopy(module)
        shardings = param_shardings(module, mesh, shard_base=True)
        dims = split_dims(shardings)
        shard_params_(module, shardings)
        if quant:  # JAX's order: shard, then quantize
            prequantize_model(ref, 16)
            prequantize_model(module, 16)
        for m in (module, ref):
            trainable_parameters(m)
            m.train()
        g = torch.Generator().manual_seed(1)
        args = inputs(g)
        outs, grads = [], []
        for m in (ref, module):
            a = [t.clone().requires_grad_(t.is_floating_point()) for t in args]
            fsdp.GATHERS.update(forward=0, backward=0)
            out = m(*a)
            live = fsdp.live_gathered()
            dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
            (out * dy).sum().backward()
            gathers = dict(fsdp.GATHERS)
            outs.append(out.detach())
            grads.append([t.grad for t in a if t.requires_grad]
                         + [p.grad for _, p in sorted(m.named_parameters()) if p.requires_grad])
        ref_params = dict(ref.named_parameters())
        full_equal, slice_equal = {}, {}
        for leaf_name in dims:
            owner, leaf = _owner(module, leaf_name)
            want = ref_params[leaf_name].detach()
            full_equal[leaf_name] = torch.equal(fsdp.full(owner, leaf), want)
            shard = fsdp.shard_of(owner, leaf)
            slice_equal[leaf_name] = torch.equal(getattr(owner, leaf), fsdp.local(shard, want))
        res = {"dims": dims, "out_equal": torch.equal(outs[0], outs[1]),
               "grads_equal": len(grads[0]) == len(grads[1]) and all(
                   torch.equal(a, b) for a, b in zip(*grads)),
               "n_grads": len(grads[1]), "full_equal": full_equal, "slice_equal": slice_equal,
               "live_after_forward": live, "gathers": gathers,
               "bytes": param_bytes(module),
               "predicted_bytes": predicted_bytes(ref, dims, mesh.shape[DATA_AXIS])}
        if name == "linear_dim0":
            # the control: the same forward without the model's hooks
            # (``forward`` called directly) saves the gathered weight as it
            # is, and the count sees it
            out = module.forward(args[0].clone().requires_grad_(True))
            res["live_unpacked"] = fsdp.live_gathered()
            del out
        return res
    finally:
        gemm_int8.GEMM_LORA_FUSED = False


def run_writers(mesh, rank: int, base: str) -> dict:
    """The writers on the tiny model with every base leaf sharded, against
    the same model unsharded."""
    cfg = tiny_model_config()
    model = build_sam3_image_model(cfg, lora=LORA)
    init_model(model, torch.Generator().manual_seed(0))
    ref = copy.deepcopy(model)
    dims = split_dims(every_leaf(model, mesh))
    shard_params_(model, every_leaf(model, mesh))
    save_base_checkpoint(ref, os.path.join(base, f"base_ref_rank{rank}.npz"))
    save_base_checkpoint(model, os.path.join(base, f"base_rank{rank}.npz"))
    merge_lora_into_base(ref)
    merge_lora_into_base(model)
    ref_params = dict(ref.named_parameters())
    merged = {}
    for name in dims:
        owner, leaf = _owner(model, name)
        merged[name] = torch.equal(fsdp.full(owner, leaf), ref_params[name])
    states = []
    for shard in (False, True):
        tcfg = TrainConfig(output_dir=os.path.join(base, f"state_{int(shard)}"), seed=0)
        trainer = Trainer(tiny_model_config(**QUANT), LORA, tcfg, device="cpu")
        trainer.setup(steps_per_epoch=1)
        if shard:
            shard_params_(trainer.model, every_leaf(trainer.model, mesh))
        states.append(trainer.save_state())
    return {"sharded": len(dims), "merged_equal": merged, "states": states}


def run_quant(mesh) -> dict:
    """``prequantize_model`` of the tiny int8 model with every base leaf
    sharded (so quantized whole, then sliced) against JAX's
    ``prequantize_base`` of the same weights, stored in
    ``tests/data/torch_ref_eval_int8.npz`` and loaded through the bridge
    (the scanned ViT blocks, which JAX leaves in fp32, quantized by the
    port, as ``tests/test_torch_quant.py`` holds equal)."""
    with np.load(os.path.join(DATA, "torch_ref_eval_int8.npz")) as d:
        specs = [(tuple(n.split(".")), tuple(s)) for n, s in json.loads(str(d["params"]))]
        quantized = {k[6:]: d[k] for k in d.files if k.startswith("quant/")}
    flat = fill_params(specs)
    cfg = tiny_model_config(**QUANT)
    model = build_sam3_image_model(cfg, lora=LORA)
    load_jax_params(model, flat)
    shardings = every_leaf(model, mesh)
    shard_params_(model, shardings)
    n = prequantize_model(model, 16)
    jax_model = build_sam3_image_model(cfg, lora=LORA)
    load_jax_params(jax_model, {**flat, **quantized})
    prequantize_model(jax_model, 16)
    want = dict(jax_model.named_parameters())
    differ, split = [], 0
    for name, m in model.named_modules():
        if isinstance(m, LoRALinear) and m.weight.dtype == torch.int8:
            split += fsdp.shard_of(m, "weight") is not None
            for leaf in ("weight", "weight_scale"):
                if not torch.equal(fsdp.full(m, leaf), want[f"{name}.{leaf}"]):
                    differ.append(f"{name}.{leaf}")
    return {"quantized": n, "split": split, "differ": differ}


def _batch(ref: dict) -> Batch:
    T = {k[3:]: torch.from_numpy(v)[list(RANK_ORDER)] for k, v in ref.items()
         if k.startswith("in/")}
    targets = Targets(T["boxes"], T["valid"], T["masks"], T["mask_valid"], T["is_exhaustive"])
    return Batch(images=T["images"], token_ids=T["token_ids"].long(),
                 img_ids=torch.arange(len(RANK_ORDER)),
                 geo=GeoPrompt(T["geo_boxes"], T["geo_mask"], T["geo_labels"].long()),
                 targets=targets)


def _tiny_int8(flat):
    model = build_sam3_image_model(tiny_model_config(**QUANT), lora=LORA)
    load_jax_params(model, flat)
    return model


STEP_RULES = {"plain": None,
              "jax_rule": lambda m, mesh: param_shardings(m, mesh, shard_base=True),
              "every_leaf": every_leaf}


def run_step(tag: str, mesh, rank: int) -> dict:
    with np.load(os.path.join(DATA, "torch_ref_train_int8_fsdp.npz")) as data:
        ref = {k: data[k] for k in data.files}
    specs = [(tuple(n.split(".")), tuple(s)) for n, s in json.loads(str(ref["params"]))]
    flat = fill_params(specs)
    local = shard_batch(_batch(ref), mesh, rank=rank)
    plain = _tiny_int8(flat)
    model, rule, dims = plain, STEP_RULES[tag], {}
    if rule is not None:  # JAX's order: shard, then quantize
        model = _tiny_int8(flat)
        dims = split_dims(rule(model, mesh))
        shard_params_(model, rule(model, mesh))
        prequantize_model(model, 16)
    prequantize_model(plain, 16)
    params = trainable_parameters(model)
    model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0
    lives = []
    model.register_forward_hook(lambda *_: lives.append(fsdp.live_gathered()))
    fsdp.GATHERS.update(forward=0, backward=0)
    losses = train_step(model, local, LossConfig(), accum=ACCUM)
    gathers = dict(fsdp.GATHERS)
    names = sorted(losses)
    stacked = torch.stack([losses[k] for k in names])
    dist_utils.all_reduce_mean_([p.grad for _, p in params] + [stacked])
    with torch.no_grad():  # the gradients under the JAX names and layout
        for _, p in params:
            p.copy_(p.grad)
        grads = stack_scanned(lora_state(model), model.spec.model)
    return {"losses": dict(zip(names, stacked)),
            "grads": {k: torch.from_numpy(v) for k, v in grads.items()},
            "dims": dims, "gathers": gathers, "live_after_forward": lives,
            "bytes": param_bytes(model),
            "predicted_bytes": predicted_bytes(plain, dims, mesh.shape[DATA_AXIS])}


PARTS = {
    "cases": lambda mesh, rank, base: {name: run_case(name, mesh, rank) for name in CASES},
    "writers": lambda mesh, rank, base: run_writers(mesh, rank, base),
    "quant": lambda mesh, rank, base: run_quant(mesh),
    **{tag: (lambda mesh, rank, base, tag=tag: run_step(tag, mesh, rank)) for tag in STEP_RULES},
}


def main(base: str, parts) -> None:
    if not multihost.initialize(backend="gloo"):
        raise SystemExit("no process group in the environment")
    rank = multihost.process_index()
    try:
        mesh = make_mesh()
        for part in parts:
            torch.save(PARTS[part](mesh, rank, base), os.path.join(base, f"{part}_rank{rank}.pt"))
    finally:
        multihost.shutdown()
    print(f"WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
