"""The port's ``train/video_data.py`` (a copy) against the JAX package's:
the same code statement for statement (syntax trees equal without the
docstrings), the same files from ``make_synthetic_ytvis`` (its JSON equal,
its JPEGs byte for byte), and every ``VideoSample`` field equal, exactly,
in train mode over two epochs (the random strides and reversals of both),
in eval mode, with a ``max_objects`` cut, and in tiling mode over each
package's ``COCOSegmentDataset``."""

import dataclasses
import json
import os

import numpy as np
import pytest

from sam3_lora_tpu.config import tiny_model_config as jax_tiny
from sam3_lora_tpu.train import data as jdata
from sam3_lora_tpu.train import video_data as jvd
from sam3_lora_tpu_torch.config import tiny_model_config
from sam3_lora_tpu_torch.train import data as pdata
from sam3_lora_tpu_torch.train import video_data as pvd

from torch_port_helpers import code_of


def test_copy_has_the_jax_code():
    assert code_of(jvd) == code_of(pvd)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("ytvis")
    return tuple(mod.make_synthetic_ytvis(str(base / name), num_videos=3, num_frames=7,
                                          img_size=48, seed=5)
                 for mod, name in ((jvd, "jax"), (pvd, "port")))


def test_synthetic_ytvis_files_equal(roots):
    jroot, proot = roots
    with open(os.path.join(jroot, "annotations.json")) as a, \
            open(os.path.join(proot, "annotations.json")) as b:
        want, got = json.load(a), json.load(b)
    assert got == want and len(want["videos"]) == 3
    for video in want["videos"]:
        for name in video["file_names"]:
            with open(os.path.join(jroot, name), "rb") as a, \
                    open(os.path.join(proot, name), "rb") as b:
                assert a.read() == b.read(), name


def assert_same(got, want, name):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f"{name} {f.name}"
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {f.name}")
        else:
            assert g == w, f"{name} {f.name}"


@pytest.mark.parametrize("mode", ["train", "eval", "max_objects"])
def test_samples_equal_jax(roots, mode):
    kw = {"train": dict(num_stages=4, stride_max=3),
          "eval": dict(num_stages=5, training=False),
          "max_objects": dict(num_stages=3, max_objects=1)}[mode]
    jroot, proot = roots
    jds = jvd.VideoGroundingDataset(jroot, model_config=jax_tiny(), seed=2, **kw)
    pds = pvd.VideoGroundingDataset(proot, model_config=tiny_model_config(), seed=2, **kw)
    assert len(pds) == len(jds) == 3
    orders = []
    for epoch in (0, 1):
        for i in range(len(jds)):
            want, got = jds.load(i, epoch=epoch), pds.load(i, epoch=epoch)
            assert_same(got, want, f"{mode} video {i} epoch {epoch}")
            orders.append(want.boxes[:, 0, 0].tolist())
    if mode == "train":  # the epochs sample other frames (strides, starts, reversals)
        assert orders[:3] != orders[3:]
    if mode == "max_objects":
        assert all((pds.load(i).track_ids >= 0).sum() <= 1 for i in range(3))


def test_tiling_samples_equal_jax(tmp_path):
    sets = []
    for data, vd, cfg, name in ((jdata, jvd, jax_tiny(), "jax"),
                                (pdata, pvd, tiny_model_config(), "port")):
        root = str(tmp_path / name)
        data.make_synthetic_coco(root, "train", num_images=3, img_size=48, seed=1)
        images = data.COCOSegmentDataset(root, "train", model_config=cfg)
        sets.append(vd.VideoGroundingDataset(root, model_config=cfg, num_stages=3,
                                             tile_image_dataset=images))
    jds, pds = sets
    for i in range(3):
        got = pds.load(i)
        assert_same(got, jds.load(i), f"tiled image {i}")
        np.testing.assert_array_equal(got.frames[0], got.frames[2])
        assert (got.track_ids >= 0).sum() == got.valid[0].sum()
