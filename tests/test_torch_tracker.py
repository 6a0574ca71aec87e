"""The port's ``TrackerCore`` (``sam3_lora_tpu_torch/models/tracker.py``) against
the JAX package's, method by method, on the tiny config (d 32, a 4x4 grid,
memory width 8) with the same seeded weights (numpy, through the weight
bridge) and the same seeded inputs, fp32: ``__call__`` (the memory attention
over 2 memory frames and 3 pointer slots with a padding mask, the SAM heads
with multimask output, the memory encoder), ``predict_masks`` with point
prompts, ``encode_memory`` with object scores, ``project_obj_ptr``,
``obj_ptr_tpos``, ``downsample_mask_input``, ``no_memory_features`` and
``assemble_memory``. Tolerance 1e-4 absolute and relative (a few stacked
fp32 layers whose sums run in another order).

The JAX results are stored in ``tests/data/torch_ref_tracker.npz`` with the
parameter shapes they were drawn at; ``test_reference_is_current`` (slow: it
jits the JAX tracker) recomputes them. Rewrite the file after a change that
moves the JAX side: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_tracker.py``.

Also: a JAX param tree (nested, as a Flax init gives it) loads strictly into
the port's module, and ``train/optim.py::jax_path`` maps every port name to
its JAX path."""

import os

import numpy as np
import pytest
import torch

from sam3_lora_tpu_torch import config as tc
from sam3_lora_tpu_torch.models import tracker
from sam3_lora_tpu_torch.models.layers import Spec
from sam3_lora_tpu_torch.train.optim import jax_path
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_tree, params_from_jax

from torch_port_helpers import fill_params, load_reference, nested, save_reference

TOL = 1e-4
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_ref_tracker.npz")
CFG = tc.tiny_model_config()
D, FH, MEM = CFG.d_model, CFG.img_size // CFG.patch_size, 8
B, NMEM, NPTR = 2, 2, 3
R = D // MEM
NPTR_TOK = NPTR * R


def inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    m = NMEM * FH * FH + NPTR_TOK
    return {
        "vis": f(B, D, FH, FH), "vpos": f(B, D, FH, FH),
        "hi0": f(B, D, 4 * FH, 4 * FH), "hi1": f(B, D, 2 * FH, 2 * FH),
        "mem": f(B, m, MEM), "mpos": f(B, m, MEM), "mmask": rng.rand(B, m) > 0.7,
        "coords": (rng.rand(B, 3, 2) * CFG.img_size).astype(np.float32),
        "labels": np.array([[1, 0, -1], [2, 3, 1]], np.int32),
        "mask_logits": f(B, 1, 4 * FH, 4 * FH), "obj": np.array([[0.5], [-0.2]], np.float32),
        "token": f(B, D), "appearing": np.array([True, False]),
        "rel": np.array([[0.0, 1.0, 3.0], [2.0, 5.0, 0.0]], np.float32),
        "small_mask": f(B, 1, 4 * FH, 4 * FH),
        "bank": f(B, NMEM, MEM, FH, FH), "bank_pos": f(B, NMEM, MEM, FH, FH),
        "tpos": np.array([[0, 3], [1, 9]], np.int32), "valid": np.array([[True, False], [True, True]]),
        "ptrs": f(B, NPTR, D), "ptr_valid": np.array([[True, True, False], [False, True, True]]),
    }


def jax_reference():
    """-> (parameter specs, the JAX TrackerCore's results on ``inputs()``)."""
    import jax.numpy as jnp

    from sam3_lora_tpu.config import tiny_model_config
    from sam3_lora_tpu.models import tracker as jtracker
    from sam3_lora_tpu.models.layers import Spec as JSpec
    from torch_port_helpers import jax_apply, random_jax_params

    x = {k: jnp.asarray(v) for k, v in inputs().items()}
    jc = jtracker.TrackerCore(JSpec(model=tiny_model_config(), lora=None), d_model=D, mem_dim=MEM,
                              feat_sizes=(FH, FH))

    def every_method(m, x):
        out = m(x["vis"], x["vpos"], x["mem"], x["mpos"], [x["hi0"], x["hi1"]],
                mem_mask=x["mmask"], num_obj_ptr_tokens=NPTR_TOK, multimask_output=True)
        res = {f"call/{k}": v for k, v in out.items() if k != "new_memory"}
        res.update({f"call/new_memory/{k}": v for k, v in out["new_memory"].items()})
        cond = m.no_memory_features(x["vis"])
        res["no_memory_features"] = cond
        for mm in (False, True):
            masks, iou, tok, obj = m.predict_masks(cond, [x["hi0"], x["hi1"]], x["coords"],
                                                   x["labels"], multimask_output=mm)
            for k, v in zip(("masks", "iou", "tokens", "obj"), (masks, iou, tok, obj)):
                res[f"predict_masks{int(mm)}/{k}"] = v
        res["condition_features"] = m.condition_features(
            x["vis"], x["vpos"], x["mem"], x["mpos"], mem_mask=x["mmask"],
            num_obj_ptr_tokens=NPTR_TOK)
        enc = m.encode_memory(x["vis"], x["mask_logits"], object_score_logits=x["obj"])
        res["encode_memory"] = enc["vision_features"]
        res["encode_memory_skip"] = m.encode_memory(x["vis"], x["mask_logits"],
                                                    skip_sigmoid=True)["vision_features"]
        res["project_obj_ptr"] = m.project_obj_ptr(x["token"], x["appearing"])
        res["obj_ptr_tpos"] = m.obj_ptr_tpos(x["rel"], 7)
        res["downsample_mask_input"] = m.downsample_mask_input(x["small_mask"])
        # the prompt encoder's mask path materializes mask_downscaling
        res["dense_from_mask"] = m.sam_prompt_encoder(masks=x["small_mask"], batch=B)[1]
        mem, pos, mask, n = m.assemble_memory(x["bank"], x["bank_pos"], x["tpos"], x["valid"],
                                              x["ptrs"], x["rel"], x["ptr_valid"], num_frames=5)
        res.update({"assemble/mem": mem, "assemble/pos": pos, "assemble/mask": mask})
        return res

    params, flat = random_jax_params(jc, x, method=every_method)
    specs = [(tuple(k.split(".")), v.shape) for k, v in flat.items()]
    out = jax_apply(jc, params, x, method=every_method)
    return specs, {k: np.asarray(v) for k, v in out.items()}, params


def port_core(specs) -> tracker.TrackerCore:
    core = tracker.TrackerCore(Spec(model=CFG, lora=None, device=torch.device("cpu")), d_model=D,
                               mem_dim=MEM, feat_sizes=(FH, FH))
    load_jax_tree(core, nested(fill_params(specs)))  # strict
    return core.eval()


@torch.no_grad()
def port_results(core):
    x = {k: torch.from_numpy(v) for k, v in inputs().items()}
    x["labels"], x["tpos"] = x["labels"].long(), x["tpos"].long()
    out = core(x["vis"], x["vpos"], x["mem"], x["mpos"], [x["hi0"], x["hi1"]], mem_mask=x["mmask"],
               num_obj_ptr_tokens=NPTR_TOK, multimask_output=True)
    res = {f"call/{k}": v for k, v in out.items() if k != "new_memory"}
    res.update({f"call/new_memory/{k}": v for k, v in out["new_memory"].items()})
    cond = core.no_memory_features(x["vis"])
    res["no_memory_features"] = cond
    for mm in (False, True):
        got = core.predict_masks(cond, [x["hi0"], x["hi1"]], x["coords"], x["labels"],
                                 multimask_output=mm)
        for k, v in zip(("masks", "iou", "tokens", "obj"), got):
            res[f"predict_masks{int(mm)}/{k}"] = v
    res["condition_features"] = core.condition_features(
        x["vis"], x["vpos"], x["mem"], x["mpos"], mem_mask=x["mmask"], num_obj_ptr_tokens=NPTR_TOK)
    res["encode_memory"] = core.encode_memory(x["vis"], x["mask_logits"],
                                              object_score_logits=x["obj"])["vision_features"]
    res["encode_memory_skip"] = core.encode_memory(x["vis"], x["mask_logits"],
                                                   skip_sigmoid=True)["vision_features"]
    res["project_obj_ptr"] = core.project_obj_ptr(x["token"], x["appearing"])
    res["obj_ptr_tpos"] = core.obj_ptr_tpos(x["rel"], 7)
    res["downsample_mask_input"] = core.downsample_mask_input(x["small_mask"])
    res["dense_from_mask"] = core.sam_prompt_encoder(masks=x["small_mask"], batch=B)[1]
    mem, pos, mask, n = core.assemble_memory(x["bank"], x["bank_pos"], x["tpos"], x["valid"],
                                             x["ptrs"], x["rel"], x["ptr_valid"], num_frames=5)
    assert n == NPTR_TOK
    res.update({"assemble/mem": mem, "assemble/pos": pos, "assemble/mask": mask})
    return {k: v.numpy() for k, v in res.items()}


def check(got, want):
    assert sorted(got) == sorted(want)
    for k, ref in want.items():
        assert got[k].shape == ref.shape, k
        if ref.dtype == bool:
            np.testing.assert_array_equal(got[k], ref, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref, rtol=TOL, atol=TOL, err_msg=k)


@pytest.fixture(scope="module")
def stored():
    return load_reference(REF)


def test_every_method_matches_jax(stored):
    specs, want = stored
    check(port_results(port_core(specs)), want)


def test_multimask_shapes_and_memory_layout(stored):
    _, want = stored
    assert want["call/masks"].shape == (B, 3, 4 * FH, 4 * FH)
    assert want["predict_masks0/masks"].shape == (B, 1, 4 * FH, 4 * FH)
    m = NMEM * FH * FH + NPTR_TOK
    assert want["assemble/mem"].shape == (B, m, MEM) and want["assemble/mask"].shape == (B, m)


def test_strict_load_and_jax_paths(stored):
    specs, _ = stored
    core = port_core(specs)
    names = {n for n, _ in core.named_parameters()}
    assert names == set(params_from_jax(fill_params(specs)))  # every parameter given, none extra
    flat = fill_params(specs)
    del flat["no_mem_embed"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_tree(core, nested(flat))


def test_reference_is_current(stored):
    """The stored reference against the live JAX tracker; the live param
    tree (nested, jax arrays) loads strictly, and the JAX paths of its
    leaves are the port's ``jax_path``s."""
    from flax import traverse_util

    specs, live, params = jax_reference()
    stored_specs, want = stored
    assert [(".".join(p), tuple(s)) for p, s in stored_specs] == \
        [(".".join(p), tuple(s)) for p, s in specs]
    assert sorted(live) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(live[k], want[k], err_msg=k)
    core = tracker.TrackerCore(Spec(model=CFG, lora=None, device=torch.device("cpu")), d_model=D,
                               mem_dim=MEM, feat_sizes=(FH, FH)).eval()
    load_jax_tree(core, params)
    check(port_results(core), live)
    paths = {"/".join(k) for k in traverse_util.flatten_dict(params)}
    assert {jax_path(core, n) for n, _ in core.named_parameters()} == paths


if __name__ == "__main__":
    specs, res, _ = jax_reference()
    print(save_reference(REF, specs, res))
