"""The port's image evaluators (``sam3_lora_tpu_torch/eval``: COCO mAP, cgF1,
TIDE, the prediction dumper) against the JAX package's, which they copy.

Seeded ground truth and detections (jittered copies of the ground truth,
duplicates, background boxes, crowd regions, images with no ground truth
or no detection) go through both; every result dict must be equal, key for
key and value for value (tolerance 0: the same numpy arithmetic). The dump
files are equal byte for byte, and ``evaluate_pred_file`` reads either
package's dump back to the live evaluation's numbers.
"""

import numpy as np
import pytest

from sam3_lora_tpu import eval as jeval
from sam3_lora_tpu.eval import writer as jwriter
from sam3_lora_tpu_torch import eval as teval
from sam3_lora_tpu_torch.eval import writer as twriter

H, W = 24, 32


def _box_mask(x0, y0, x1, y1):
    m = np.zeros((H, W), bool)
    m[y0:y1, x0:x1] = True
    return m


def _mask_box(m):
    ys, xs = np.nonzero(m)
    return [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
            float(ys.max() - ys.min() + 1)]


def seeded_gts_dts(seed: int = 0, n_images: int = 9):
    rng = np.random.RandomState(seed)
    gts, dts = {}, {}
    for img in range(n_images):
        g = []
        for _ in range(rng.randint(0, 4) if img != 0 else 0):  # image 0: no ground truth
            x0, y0 = rng.randint(0, W - 8), rng.randint(0, H - 8)
            m = _box_mask(x0, y0, x0 + rng.randint(4, 8), y0 + rng.randint(4, 8))
            g.append({"mask": m, "box": _mask_box(m), "iscrowd": int(rng.rand() < 0.15)})
        d = []
        if img != 1:  # image 1: no detection
            for gt in g:
                m = np.roll(gt["mask"], rng.randint(-2, 3), axis=rng.randint(0, 2))
                d.append({"mask": m, "box": _mask_box(m), "score": float(rng.rand())})
                if rng.rand() < 0.4:  # a duplicate
                    d.append({"mask": m.copy(), "box": _mask_box(m),
                              "score": float(rng.rand())})
            for _ in range(rng.randint(0, 3)):  # background
                x0, y0 = rng.randint(0, W - 4), rng.randint(0, H - 4)
                m = _box_mask(x0, y0, x0 + 3, y0 + 3)
                d.append({"mask": m, "box": _mask_box(m), "score": float(rng.rand())})
        gts[img], dts[img] = g, d
    return gts, dts


@pytest.mark.parametrize("iou_type", ["segm", "bbox"])
@pytest.mark.parametrize("seed", [0, 1])
def test_coco_map_cgf1_tide_equal_jax(iou_type, seed):
    gts, dts = seeded_gts_dts(seed)
    for name in ("evaluate_coco_map", "evaluate_cgf1", "tide_errors"):
        want = getattr(jeval, name)(gts, dts, iou_type=iou_type)
        got = getattr(teval, name)(gts, dts, iou_type=iou_type)
        assert list(got) == list(want) and got == want, name
    # the non-default settings too
    thrs = np.linspace(0.4, 0.85, 10)
    assert (teval.evaluate_coco_map(gts, dts, iou_type, max_dets=2, iou_thrs=thrs)
            == jeval.evaluate_coco_map(gts, dts, iou_type, max_dets=2, iou_thrs=thrs))
    assert (teval.evaluate_cgf1(gts, dts, iou_type, score_threshold=0.3)
            == jeval.evaluate_cgf1(gts, dts, iou_type, score_threshold=0.3))
    assert (teval.tide_errors(gts, dts, iou_type, fg_thresh=0.6, bg_thresh=0.2)
            == jeval.tide_errors(gts, dts, iou_type, fg_thresh=0.6, bg_thresh=0.2))


def test_exports_are_the_image_evaluators():
    assert sorted(teval.__all__) == sorted(
        n for n in jeval.__all__ if n in ("evaluate_coco_map", "evaluate_cgf1",
                                          "PredictionDumper", "evaluate_pred_file",
                                          "load_predictions", "tide_errors"))


def _dump(mod, out_dir, dts, top_k):
    d = mod.PredictionDumper(str(out_dir), top_k=top_k)
    for iid, recs in dts.items():
        if recs:
            d.add(iid, [r["score"] for r in recs],
                  boxes=np.asarray([[b[0], b[1], b[0] + b[2], b[1] + b[3]]
                                    for b in (r["box"] for r in recs)]),
                  masks=np.stack([r["mask"] for r in recs]))
        if iid == 3:
            d.flush([iid])  # an early flush of one image
    return d.finalize()


@pytest.mark.parametrize("top_k", [100, 2])
def test_writer_dump_and_offline_eval_equal_jax(tmp_path, top_k):
    gts, dts = seeded_gts_dts(2)
    jpath = _dump(jwriter, tmp_path / "jax", dts, top_k)
    tpath = _dump(twriter, tmp_path / "port", dts, top_k)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    assert teval.load_predictions(tpath) == jeval.load_predictions(jpath)
    for iou_type in ("segm", "bbox"):
        got = teval.evaluate_pred_file(tpath, gts, iou_type=iou_type)
        assert got == jeval.evaluate_pred_file(jpath, gts, iou_type=iou_type)
    if top_k == 100:
        # every detection survives: the round trip gives the live numbers
        live = teval.evaluate_coco_map(gts, dts)
        live.update(teval.evaluate_cgf1(gts, dts))
        assert teval.evaluate_pred_file(tpath, gts) == live
    custom = {"n": lambda g, d: sum(len(v) for v in d.values())}
    assert (teval.evaluate_pred_file(tpath, gts, evaluators=custom)
            == jeval.evaluate_pred_file(jpath, gts, evaluators=custom))
