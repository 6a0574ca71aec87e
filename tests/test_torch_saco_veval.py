"""The port's ``eval/saco_veval.py`` (a copy) against the JAX package's: the
same code statement for statement (syntax trees equal without the
docstrings), the same prediction records from ``prepare_video_predictions``
(masks and boxes of seeded tracks with absent frames), and every metric of
``evaluate_saco_veval`` (video mAP, phrase AP, video cgF1 and IL_MCC,
phrase HOTA, TETA) and of a two-shard ``SacoVevalWriter`` round trip with
a duplicated (video, category) equal, tolerance 0 (the same numpy and scipy
arithmetic); the port's ``eval`` package exports what JAX's does; and
chip_smoke's saco_veval check rehearsed on the CPU."""

import json
import os

import numpy as np
import pytest

import chip_smoke
from sam3_lora_tpu import eval as jeval_pkg
from sam3_lora_tpu.eval import saco_veval as jsv
from sam3_lora_tpu_torch import eval as teval_pkg
from sam3_lora_tpu_torch.eval import saco_veval as tsv

from torch_port_helpers import code_of

H, W, T = 32, 40, 5
EVALUATORS = ("video_map", "phrase_ap", "video_cgf1", "phrase_hota", "teta")


def test_copy_has_the_jax_code():
    assert code_of(jsv) == code_of(tsv)


def test_eval_package_exports_what_jax_does():
    assert teval_pkg.__all__ == jeval_pkg.__all__
    assert all(hasattr(teval_pkg, name) for name in jeval_pkg.__all__)


def tracks(rng, n):
    """(n, T, H, W) bool masks of moving boxes, a frame absent now and then,
    and their (n, T, 4) xyxy boxes (zero where absent)."""
    masks = np.zeros((n, T, H, W), bool)
    boxes = np.zeros((n, T, 4))
    for i in range(n):
        y, x = rng.randint(0, H - 12), rng.randint(0, W - 12)
        h, w = rng.randint(5, 12, 2)
        vy, vx = rng.randint(-2, 3, 2)
        for t in range(T):
            if rng.rand() < 0.15 and t:
                continue
            y0, x0 = int(np.clip(y + vy * t, 0, H - h)), int(np.clip(x + vx * t, 0, W - w))
            masks[i, t, y0:y0 + h, x0:x0 + w] = True
            boxes[i, t] = [x0, y0, x0 + w, y0 + h]
    return masks, boxes


def workload(seed, prepare):
    """-> (ground truth dict, prediction records): 3 videos x 2 categories,
    jittered predictions of each track, a false track now and then, and a
    (video, category) pair without ground truth."""
    rng = np.random.RandomState(seed)
    videos, anns, preds, pairs = [], [], [], []
    for vid in (1, 2, 3):
        videos.append({"id": vid, "height": H, "width": W, "length": T,
                       "file_names": [f"v{vid}/{t}.jpg" for t in range(T)]})
        for cid in (1, 2):
            pairs.append({"video_id": vid, "category_id": cid})
            if (vid, cid) == (3, 2):
                continue
            n = rng.randint(1, 4)
            masks, boxes = tracks(rng, n)
            for rec in prepare(vid, np.ones(n), np.full(n, cid), None, masks):
                anns.append({"id": len(anns) + 1, "iscrowd": 0, "height": H, "width": W,
                             **{k: rec[k] for k in ("video_id", "category_id", "segmentations",
                                                    "bboxes", "areas")}})
            shift = rng.randint(-2, 3, (n, 2))  # (dy, dx) a track
            pm = np.stack([np.roll(masks[i], tuple(shift[i]), axis=(1, 2)) for i in range(n)])
            pb = boxes + np.concatenate([shift[:, ::-1]] * 2, axis=-1)[:, None]
            if rng.rand() < 0.5:  # a false track
                fm, fb = tracks(rng, 1)
                pm, pb = np.concatenate([pm, fm]), np.concatenate([pb, fb])
            scores = rng.uniform(0.3, 1.0, len(pm))
            preds += prepare(vid, scores, np.full(len(pm), cid), pb, pm)
    gt = {"videos": videos, "annotations": anns, "video_np_pairs": pairs,
          "categories": [{"id": 1, "name": "crack"}, {"id": 2, "name": "stain"}]}
    return gt, preds


def test_prepare_video_predictions_equals_jax():
    rng = np.random.RandomState(0)
    masks, boxes = tracks(rng, 3)
    args = (7, np.array([0.9, 0.8, 0.7]), np.array([1, 1, 2]))
    for b, m in ((boxes, masks), (None, masks), (boxes, None)):
        want = jsv.prepare_video_predictions(*args, boxes=b, masks=m)
        assert tsv.prepare_video_predictions(*args, boxes=b, masks=m) == want
    records = jsv.prepare_video_predictions(*args, masks=masks)
    assert tsv.dedup_video_predictions([records, records[:1]]) == \
        jsv.dedup_video_predictions([records, records[:1]])


def assert_same(got, want, name):
    assert sorted(got) == sorted(want), name
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_saco_veval_equals_jax(seed):
    gt, preds = workload(seed, jsv.prepare_video_predictions)
    assert workload(seed, tsv.prepare_video_predictions) == (gt, preds)
    want, want_rows = jsv.evaluate_saco_veval(gt, preds, EVALUATORS)
    got, got_rows = tsv.evaluate_saco_veval(gt, preds, EVALUATORS)
    assert_same(got, want, f"seed {seed}")
    assert got_rows == want_rows
    # IL_MCC is NaN where its denominator is 0 (here at IoU 0.75), as in JAX
    assert all(np.isfinite(v) for k, v in got.items() if "ilmcc" not in k) and len(got) == 54


def test_writer_two_shards_equal_jax(tmp_path):
    gt, preds = workload(2, jsv.prepare_video_predictions)
    half = len(preds) // 2
    shards = (preds[:half], preds[half:] + preds[:1])  # the first record on both ranks
    meters = []
    for sv, name in ((jsv, "jax"), (tsv, "port")):
        path = str(tmp_path / name / "preds.json")
        for rank, records in enumerate(shards):
            writer = sv.SacoVevalWriter(path, evaluators=EVALUATORS)
            writer.add_records(records)
            writer.write_shard(rank)
        meters.append(sv.SacoVevalWriter(path, evaluators=EVALUATORS).finalize(gt, num_shards=2))
        with open(path) as f:
            dumped = json.load(f)
        with open(path + ".sam3_eval_metrics") as f:
            assert json.load(f)["dataset_level_metrics"] == meters[-1]
        meters.append(dumped)
    jax_meters, jax_dump, port_meters, port_dump = meters
    assert port_dump == jax_dump and port_dump
    assert_same(port_meters, jax_meters, "writer")


def test_chip_smoke_saco_veval_check_on_the_cpu(tmp_path):
    """chip_smoke's saco_veval check on grounder-shaped outputs (a dict a
    frame: live ids, scores, masks at the mask resolution; an id that
    starts late, one that ends early, one that never has a mask): the
    tracks, the writer's meters equal to evaluate_saco_veval's on a copy of
    the records, the self-scored APs 1.0, and the lesser ground truths
    below it."""
    rng = np.random.RandomState(3)
    masks, _ = tracks(rng, 4)
    masks[3] = False                       # never a mask: not a track
    outs = []
    for t in range(T):
        ids = [i for i in range(4) if not (i == 1 and t < 2) and not (i == 2 and t > 3)]
        outs.append({"obj_ids": np.array([10 + i for i in ids]),
                     "scores": rng.uniform(0.2, 1.0, len(ids)).astype(np.float32),
                     "masks_lowres": masks[ids, t]})
    got, scores = chip_smoke.video_tracks(outs)
    assert got.shape == (3, T, H, W) and not got[1, :2].any() and not got[2, 4:].any()
    res = chip_smoke.saco_veval_check(outs, str(tmp_path))
    chip_smoke.check_saco_veval("video", res)
    assert res["shifted"][0]["video_mask_mAP_50_95"] < 1.0
    assert os.path.exists(tmp_path / "preds.json.shard0")
