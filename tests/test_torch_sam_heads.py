"""The port's SAM heads (``sam3_lora_tpu_torch/models/sam_heads.py``) against
the JAX package's, on the tiny width (d 32, a 4x4 grid, input 56) with the
same seeded weights and inputs, fp32. Tolerance 1e-4 absolute and relative
(a few stacked fp32 layers whose sums run in another order).

``PromptEncoder``: points alone (one "not a point" slot appended), points
with boxes, boxes alone, a mask prompt, and the dense PE. ``MaskDecoder``:
multimask and single output (the dynamic selection by stability), with
raw high-res maps (projected by the decoder) and projected ones. The JAX
results are stored in ``tests/data/torch_ref_sam_heads.npz``;
``test_reference_is_current`` (slow: it jits the JAX heads) recomputes
them. Rewrite: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_sam_heads.py``.

The dynamic selection itself (``_dynamic_multimask``) is held against
JAX's live, exactly (same selection, bit for bit), on hand-made inputs:
exact and near ties of the IoU, mask values on the +-delta boundary, a
stability exactly at the threshold, and an empty union."""

import os

import numpy as np
import torch

from sam3_lora_tpu_torch import config as tc
from sam3_lora_tpu_torch.models import sam_heads
from sam3_lora_tpu_torch.models.layers import Spec
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import fill_params, load_reference, save_reference

TOL = 1e-4
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_ref_sam_heads.npz")
CFG = tc.tiny_model_config()
D, FH, IMG = CFG.d_model, CFG.img_size // CFG.patch_size, CFG.img_size
B = 2


def inputs():
    rng = np.random.RandomState(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "coords": (rng.rand(B, 4, 2) * IMG).astype(np.float32),
        "labels": np.array([[1, 0, -1, 1], [2, 3, 0, -1]], np.int32),
        "boxes": np.sort(rng.rand(B, 2, 4) * IMG, axis=-1).astype(np.float32),
        "masks": f(B, 1, 4 * FH, 4 * FH),
        "img": f(B, D, FH, FH), "sparse": f(B, 5, D), "dense": f(B, D, FH, FH),
        "hi0": f(B, D, 4 * FH, 4 * FH), "hi1": f(B, D, 2 * FH, 2 * FH),
        "hi0p": f(B, D // 8, 4 * FH, 4 * FH), "hi1p": f(B, D // 4, 2 * FH, 2 * FH),
    }


def _specs(flat):
    return [(tuple(k.split(".")), v.shape) for k, v in flat.items()]


def jax_reference():
    """-> ({"pe": specs, "dec": specs}, the JAX heads' results on ``inputs()``)."""
    import jax.numpy as jnp

    from sam3_lora_tpu.config import tiny_model_config
    from sam3_lora_tpu.models import sam_heads as jsam
    from sam3_lora_tpu.models.layers import Spec as JSpec
    from torch_port_helpers import jax_apply, random_jax_params

    x = {k: jnp.asarray(v) for k, v in inputs().items()}
    spec = JSpec(model=tiny_model_config(), lora=None)
    pe = jsam.PromptEncoder(spec, embed_dim=D, image_embedding_size=(FH, FH),
                            input_image_size=(IMG, IMG))

    def prompts(m, x):
        out = {}
        out["points/sparse"], out["points/dense"] = m(points=(x["coords"], x["labels"]))
        out["both/sparse"], _ = m(points=(x["coords"], x["labels"]), boxes=x["boxes"])
        out["boxes/sparse"], _ = m(boxes=x["boxes"])
        out["mask/sparse"], out["mask/dense"] = m(masks=x["masks"], batch=B)
        out["dense_pe"] = m.get_dense_pe()
        return out

    pe_params, pe_flat = random_jax_params(pe, x, method=prompts, seed=2)
    res = {f"pe/{k}": v for k, v in jax_apply(pe, pe_params, x, method=prompts).items()}

    dec = jsam.MaskDecoder(spec, transformer_dim=D)
    pe_img = jnp.asarray(res["pe/dense_pe"])

    def decode(m, x, pe_img):
        out = {}
        for mm in (True, False):
            got = m(x["img"], pe_img, x["sparse"], x["dense"], multimask_output=mm,
                    high_res_features=[x["hi0"], x["hi1"]], project_high_res=True)
            out.update({f"raw{int(mm)}/{k}": v for k, v in zip(("masks", "iou", "tokens", "obj"), got)})
        got = m(x["img"], pe_img, x["sparse"], x["dense"], multimask_output=False,
                high_res_features=[x["hi0p"], x["hi1p"]])
        out.update({f"projected/{k}": v for k, v in zip(("masks", "iou", "tokens", "obj"), got)})
        return out

    dec_params, dec_flat = random_jax_params(dec, x, pe_img, method=decode, seed=3)
    res.update({f"dec/{k}": v for k, v in jax_apply(dec, dec_params, x, pe_img, method=decode).items()})
    specs = {"pe": _specs(pe_flat), "dec": _specs(dec_flat)}
    return specs, {k: np.asarray(v) for k, v in res.items()}


def port_heads(specs):
    spec = Spec(model=CFG, lora=None, device=torch.device("cpu"))
    pe = sam_heads.PromptEncoder(spec, embed_dim=D, image_embedding_size=(FH, FH),
                                 input_image_size=(IMG, IMG))
    load_jax_params(pe, fill_params(specs["pe"], seed=2))
    dec = sam_heads.MaskDecoder(spec, transformer_dim=D)
    load_jax_params(dec, fill_params(specs["dec"], seed=3))
    return pe.eval(), dec.eval()


@torch.no_grad()
def port_results(pe, dec):
    x = {k: torch.from_numpy(v) for k, v in inputs().items()}
    x["labels"] = x["labels"].long()
    out = {}
    out["pe/points/sparse"], out["pe/points/dense"] = pe(points=(x["coords"], x["labels"]))
    out["pe/both/sparse"], _ = pe(points=(x["coords"], x["labels"]), boxes=x["boxes"])
    out["pe/boxes/sparse"], _ = pe(boxes=x["boxes"])
    out["pe/mask/sparse"], out["pe/mask/dense"] = pe(masks=x["masks"], batch=B)
    out["pe/dense_pe"] = pe.get_dense_pe()
    pe_img = out["pe/dense_pe"]
    names = ("masks", "iou", "tokens", "obj")
    for mm in (True, False):
        got = dec(x["img"], pe_img, x["sparse"], x["dense"], multimask_output=mm,
                  high_res_features=[x["hi0"], x["hi1"]], project_high_res=True)
        out.update({f"dec/raw{int(mm)}/{k}": v for k, v in zip(names, got)})
    got = dec(x["img"], pe_img, x["sparse"], x["dense"], multimask_output=False,
              high_res_features=[x["hi0p"], x["hi1p"]])
    out.update({f"dec/projected/{k}": v for k, v in zip(names, got)})
    return {k: v.numpy() for k, v in out.items()}


def check(got, want):
    assert sorted(got) == sorted(want)
    for k, ref in want.items():
        assert got[k].shape == ref.shape, k
        np.testing.assert_allclose(got[k], ref, rtol=TOL, atol=TOL, err_msg=k)


def _load():
    specs, arrays = load_reference(REF)
    n_pe = int(arrays.pop("n_pe_params"))
    return {"pe": specs[:n_pe], "dec": specs[n_pe:]}, arrays


def test_heads_match_jax():
    specs, want = _load()
    check(port_results(*port_heads(specs)), want)


def test_output_shapes():
    _, want = _load()
    assert want["pe/points/sparse"].shape == (B, 5, D)  # 4 points + the pad slot
    assert want["pe/both/sparse"].shape == (B, 4 + 4, D)  # no pad slot with boxes
    assert want["pe/mask/dense"].shape == want["pe/points/dense"].shape == (B, D, FH, FH)
    assert want["dec/raw1/masks"].shape == (B, 3, 4 * FH, 4 * FH)
    assert want["dec/raw0/masks"].shape == (B, 1, 4 * FH, 4 * FH)
    assert want["dec/raw1/tokens"].shape == (B, 3, D) and want["dec/raw0/tokens"].shape == (B, 1, D)


def _tie_cases():
    """(all_masks (N, 4, 5, 10), all_iou (N, 4)): each row one case, the
    single-output token's 50 logits first."""
    delta = np.float32(0.05)
    single = np.ones((9, 50), np.float32)
    single[1] = -1.0                        # empty union: stability 1, stable
    single[2, :1] = 0.0                     # 49 / 50 = 0.98: at the threshold, stable
    single[3, :2] = 0.0                     # 48 / 50: unstable
    single[4, :1] = delta                   # on +delta (strict >): 49 / 50, stable
    single[5, :1], single[5, 1:2] = delta, -delta  # +delta and -delta: 48 / 49, unstable
    single[6, :2] = 0.0                     # unstable, an exact IoU tie below
    single[7, :2] = 0.0                     # unstable, a near tie below
    single[8, :2] = 0.0                     # unstable, all three tied
    multi = np.random.RandomState(4).standard_normal((9, 3, 50)).astype(np.float32)
    iou = np.random.RandomState(5).rand(9, 4).astype(np.float32)
    iou[6, 1:] = [0.7, 0.9, 0.9]           # exact tie: the first wins
    iou[7, 1:] = [0.9, np.nextafter(np.float32(0.9), np.float32(1)), 0.9]  # a one-ulp lead
    iou[8, 1:] = [0.5, 0.5, 0.5]
    masks = np.concatenate([single[:, None], multi], axis=1).reshape(9, 4, 5, 10)
    return masks, iou


def test_dynamic_multimask_selects_as_jax():
    """Stability exactly at the threshold (49 / 50 = 0.98 in fp32), logits
    on +-delta, ties and near ties of the IoU: the same token and the same
    numbers as JAX's, and the selections the cases were built for."""
    import jax.numpy as jnp

    from sam3_lora_tpu.config import tiny_model_config
    from sam3_lora_tpu.models import sam_heads as jsam
    from sam3_lora_tpu.models.layers import Spec as JSpec

    masks, iou = _tie_cases()
    jdec = jsam.MaskDecoder(JSpec(model=tiny_model_config(), lora=None))
    jm, ji = jdec._dynamic_multimask(jnp.asarray(masks), jnp.asarray(iou))
    dec = sam_heads.MaskDecoder(Spec(model=CFG, lora=None, device=torch.device("cpu")),
                                transformer_dim=D)
    pm, pi = dec._dynamic_multimask(torch.from_numpy(masks), torch.from_numpy(iou))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    picked = [int(np.argmax(iou[r, 1:])) + 1 for r in range(len(iou))]
    assert picked[6] == 2 and picked[7] == 2 and picked[8] == 1
    stable = (0, 1, 2, 4)
    for r in range(len(iou)):
        want = masks[r, 0] if r in stable else masks[r, picked[r]]
        np.testing.assert_array_equal(pm[r, 0].numpy(), want, err_msg=str(r))


def test_reference_is_current():
    specs, live = jax_reference()
    stored_specs, want = _load()
    for part in ("pe", "dec"):
        assert [(".".join(p), tuple(s)) for p, s in stored_specs[part]] == \
            [(".".join(p), tuple(s)) for p, s in specs[part]]
    for k in want:
        np.testing.assert_array_equal(live[k], want[k], err_msg=k)
    check(port_results(*port_heads(specs)), live)


if __name__ == "__main__":
    specs, res = jax_reference()
    res["n_pe_params"] = np.asarray(len(specs["pe"]))
    print(save_reference(REF, specs["pe"] + specs["dec"], res))
