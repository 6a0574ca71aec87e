"""The port's data pipeline against the JAX package's, on the same synthetic
COCO dataset: the files ``make_synthetic_coco`` writes, and every array of
every batch the two ``DataLoader``s yield (shuffled order, images, token
ids, geometry, padded targets and masks), equal exactly; ``dummy_batch``
equal to the JAX one; and the trainer's split of a batch into microbatches
for gradient accumulation."""

import json
import os

import numpy as np
import pytest
import torch

from sam3_lora_tpu.config import tiny_model_config
from sam3_lora_tpu.models.builder import dummy_batch as jax_dummy_batch
from sam3_lora_tpu.train import data as jdata
from sam3_lora_tpu_torch.models import dummy_batch
from sam3_lora_tpu_torch.train import data as pdata
from sam3_lora_tpu_torch.train.trainer import split_microbatches


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("coco")
    jroot, proot = str(base / "jax"), str(base / "port")
    for mod, r in ((jdata, jroot), (pdata, proot)):
        mod.make_synthetic_coco(r, "train", num_images=6, img_size=64, seed=3,
                                extra_categories=("wall",))
    return jroot, proot


def test_synthetic_coco_files_equal(root):
    jroot, proot = root
    names = sorted(os.listdir(os.path.join(jroot, "train")))
    assert names == sorted(os.listdir(os.path.join(proot, "train")))
    for name in names:
        with open(os.path.join(jroot, "train", name), "rb") as a, \
                open(os.path.join(proot, "train", name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(proot, "train", "_annotations.coco.json")) as f:
        assert len(json.load(f)["images"]) == 6


def _arrays(batch):
    t = batch.targets
    return {
        "images": batch.images, "token_ids": batch.token_ids, "img_ids": batch.img_ids,
        "geo.boxes": batch.geo.boxes, "geo.mask": batch.geo.mask, "geo.labels": batch.geo.labels,
        "boxes": t.boxes, "valid": t.valid, "masks": t.masks, "mask_valid": t.mask_valid,
        "is_exhaustive": t.is_exhaustive,
    }


@pytest.mark.parametrize("per_category", [False, True])
def test_loader_batches_equal_jax(root, per_category):
    jroot, proot = root
    cfg = tiny_model_config(img_size=56, mask_loss_resolution=14)
    kw = dict(per_category_queries=per_category, include_negatives=per_category)
    jds = jdata.COCOSegmentDataset(jroot, "train", model_config=cfg, **kw)
    pds = pdata.COCOSegmentDataset(proot, "train", model_config=cfg, **kw)
    assert len(jds) == len(pds)
    jl = jdata.DataLoader(jds, 2, shuffle=True, seed=5, num_workers=1)
    pl = pdata.DataLoader(pds, 2, shuffle=True, seed=5, num_workers=1)
    assert len(jl) == len(pl)
    n = 0
    for jb, pb in zip(jl.epoch(1), pl.epoch(1)):
        ja, pa = _arrays(jb), _arrays(pb)
        for k in ja:
            np.testing.assert_array_equal(pa[k].numpy(), np.asarray(ja[k]), err_msg=k)
        n += 1
    assert n == len(pl)
    assert any(_arrays(b)["valid"].any() for b in pl.epoch(0))


def test_microbatches_carry_the_images_of_their_rows(root):
    """Gradient accumulation splits a batch by rows; each microbatch keeps
    the images its rows index (the rows of a batch may share an image)."""
    cfg = tiny_model_config(img_size=56, mask_loss_resolution=14)
    ds = pdata.COCOSegmentDataset(root[1], "train", model_config=cfg)
    batch = pdata.collate([ds.load(i) for i in range(4)], cfg=cfg)
    batch.images, batch.img_ids = batch.images[:3], torch.tensor([2, 0, 1, 0])
    mbs = split_microbatches(batch, 2)
    assert len(mbs) == 2
    for i, mb in enumerate(mbs):
        rows = slice(2 * i, 2 * i + 2)
        assert torch.equal(mb.images[mb.img_ids], batch.images[batch.img_ids[rows]])
        assert torch.equal(mb.token_ids, batch.token_ids[rows])
        assert torch.equal(mb.targets.masks, batch.targets.masks[rows])
        assert torch.equal(mb.geo.boxes, batch.geo.boxes[rows])


@pytest.mark.parametrize("with_targets", [False, True])
def test_dummy_batch_equals_jax(with_targets):
    cfg = tiny_model_config()
    jb = jax_dummy_batch(cfg, batch_size=3, with_targets=with_targets, num_images=2)
    pb = dummy_batch(cfg, batch_size=3, with_targets=with_targets, num_images=2)
    pairs = [(pb.images, jb.images), (pb.token_ids, jb.token_ids), (pb.img_ids, jb.img_ids),
             (pb.geo.boxes, jb.geo.boxes), (pb.geo.mask, jb.geo.mask),
             (pb.geo.labels, jb.geo.labels)]
    if with_targets:
        pt, jt = pb.targets, jb.targets
        pairs += [(getattr(pt, f), getattr(jt, f))
                  for f in ("boxes", "valid", "masks", "mask_valid", "is_exhaustive")]
    else:
        assert pb.targets is None and jb.targets is None
    for p, j in pairs:
        assert tuple(p.shape) == tuple(j.shape)
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_dummy_batch_with_mask_prompts_equals_jax():
    """With ``geo_mask_prompts`` both packages' zero batches carry one padded
    mask prompt a row (JAX's materializes the mask encoder's parameters)."""
    cfg = tiny_model_config(geo_mask_prompts=True)
    jb = jax_dummy_batch(cfg, batch_size=2)
    pb = dummy_batch(cfg, batch_size=2)
    for f in ("mask_embeddings", "mask_mask", "mask_labels"):
        p, j = getattr(pb.geo, f), getattr(jb.geo, f)
        assert tuple(p.shape) == tuple(j.shape), f
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=f)
    assert dummy_batch(tiny_model_config(), batch_size=2).geo.mask_embeddings is None
