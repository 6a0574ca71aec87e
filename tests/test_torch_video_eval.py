"""The port's ``eval/video_eval.py`` (a copy) against the JAX package's:
the same code statement for statement (syntax trees equal without the
docstrings), and HOTA, CLEAR-MOT, track mAP, TETA and the track IoU on
seeded tracks of masks and of boxes (jittered, split, swapped and spurious
predictions, tracks that start late): every metric equal, tolerance 0
(the same numpy and scipy arithmetic)."""

import numpy as np
import pytest

from sam3_lora_tpu.eval import video_eval as jeval
from sam3_lora_tpu_torch.eval import video_eval as teval

from torch_port_helpers import code_of


def test_copy_has_the_jax_code():
    assert code_of(jeval) == code_of(teval)


def assert_same(got: dict, want: dict, name: str) -> None:
    assert sorted(got) == sorted(want), name
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
        assert np.isfinite(got[k]).all(), f"{name} {k}"


def _mask(size, cy, cx, r):
    yy, xx = np.mgrid[:size, :size]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def tracks(seed: int, boxes: bool):
    """-> (gt, pred, pred_scores): 4 ground-truth objects over 8 frames;
    predictions jittered, one split in two ids, two swapped half way, one
    spurious, one starting late."""
    rng = np.random.RandomState(seed)
    n_frames, size = 8, 40

    def det(cy, cx, r):
        if boxes:
            return np.array([cx - r, cy - r, cx + r, cy + r], np.float64)
        return _mask(size, cy, cx, r)

    gt, pred = {}, {}
    for t in range(4):
        cy, cx, r = rng.randint(8, 32), rng.randint(8, 32), rng.randint(3, 7)
        vy, vx = rng.randint(-2, 3, 2)
        start = 2 if t == 3 else 0
        gt[t] = {f: det(cy + vy * f, cx + vx * f, r) for f in range(start, n_frames)}
        jit = rng.randint(-1, 2, (n_frames, 2))
        pred[10 + t] = {f: det(cy + vy * f + jit[f, 0], cx + vx * f + jit[f, 1], r)
                        for f in range(start + (t == 3), n_frames) if not (t == 1 and f >= 5)}
    pred[20] = {f: gt[1][f] for f in range(5, n_frames)}           # track 1 split
    pred[10], pred[12] = ({f: (pred[10] if f < 4 else pred[12])[f] for f in range(n_frames)},
                          {f: (pred[12] if f < 4 else pred[10])[f] for f in range(n_frames)})
    pred[30] = {f: det(*rng.randint(8, 32, 2), 4) for f in range(3, 6)}  # spurious
    scores = {k: float(rng.rand()) for k in pred}
    return gt, pred, scores


@pytest.mark.parametrize("boxes", [False, True], ids=["masks", "boxes"])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal_jax(seed, boxes):
    gt, pred, scores = tracks(seed, boxes)
    for name, args in (("evaluate_hota", (gt, pred)), ("evaluate_clear_mot", (gt, pred)),
                       ("evaluate_track_map", (gt, pred, scores)), ("evaluate_teta", (gt, pred))):
        assert_same(getattr(teval, name)(*args), getattr(jeval, name)(*args), name)
    for a in gt.values():
        for b in pred.values():
            assert teval.track_iou(a, b) == jeval.track_iou(a, b)
    # the cases are not degenerate: the errors show in the metrics
    mot = teval.evaluate_clear_mot(gt, pred)
    assert 0 < teval.evaluate_hota(gt, pred)["HOTA"] < 1 and mot["IDSW"] > 0


def test_metrics_equal_jax_with_options():
    gt, pred, scores = tracks(2, False)
    for name, args, kw in (("evaluate_hota", (gt, pred), dict(alphas=[0.3, 0.6])),
                           ("evaluate_clear_mot", (gt, pred), dict(iou_threshold=0.3)),
                           ("evaluate_track_map", (gt, pred, scores), dict(iou_thrs=[0.5, 0.7])),
                           ("evaluate_teta", (gt, pred), dict(thr=30))):
        assert_same(getattr(teval, name)(*args, **kw), getattr(jeval, name)(*args, **kw), name)
