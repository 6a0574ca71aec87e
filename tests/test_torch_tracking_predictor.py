"""The port's ``Sam3TrackerPredictor`` (``sam3_lora_tpu_torch/
tracking_predictor.py``) against the JAX package's, on the CPU at the tiny
config with the same weights: the processor's and a JAX ``TrackerCore``
tree as the JAX predictor's init traces it, filled from numpy (3 slots, 3
memory frames, 4 pointers), fp32 on both sides, the same seeded 40x60
frames (the shape at which the port's resize gives PIL's pixels; see
``test_torch_video.py``).

Sessions: a click on frame 0, then ``propagate_in_video`` over 5 frames
(the ring of 2 evicts); a box for one object and a click for a second,
tracked for 2 frames from frame 1; a mask prompt (``add_new_mask``), then
propagation; ``reset_state`` in between. The returned mask logits, each
frame's live ids and masks, and the final state: ids, ages and every
discrete field equal, logits, banks and pointers within 2e-4 (the
processor-level tolerance).

The JAX results are stored in ``tests/data/torch_ref_video_tracker.npz``;
``test_reference_is_current`` (slow: it jits the JAX heads and tracker)
recomputes them. Rewrite: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_tracking_predictor.py``."""

import os

import numpy as np
import pytest
import torch

from sam3_lora_tpu_torch.tracking_predictor import Sam3TrackerPredictor
from sam3_lora_tpu_torch.video import TrackState

from torch_port_helpers import (
    fill_params, jax_tiny_processor, jax_video_tracker, load_reference, nested,
    port_tiny_processor, save_reference,
)

TOL = 2e-4
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_ref_video_tracker.npz")
NM, NP, K = 3, 4, 3
FRAMES = [np.random.RandomState(30 + i).randint(0, 256, (40, 60, 3)).astype(np.uint8)
          for i in range(5)]
MASK = np.zeros((40, 60), np.uint8)
MASK[8:30, 12:40] = 1
DISCRETE = ("alive", "obj_ids", "maskmem_age", "obj_ptr_age", "missing_frames", "hotstart",
            "last_occluded", "frame_idx", "next_id")


def session(pred):
    """Drive ``pred`` through the three sessions -> {name: array}."""
    res = {}

    def record(tag, outs):
        res[f"{tag}/frames"] = np.array([o[0] for o in outs])
        for i, (_, ids, masks) in enumerate(outs):
            res[f"{tag}/{i}/ids"], res[f"{tag}/{i}/masks"] = np.asarray(ids), np.asarray(masks)
        for k, v in pred._state.track._asdict().items():
            res[f"{tag}/state/{k}"] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)

    pred.init_state(FRAMES)
    oid, m = pred.add_new_points_or_box(0, obj_id=7, points=np.array([[30.0, 20.0]]),
                                        labels=np.array([1]))
    res["click/oid"], res["click/mask"] = np.asarray(oid), np.asarray(m)
    record("click", list(pred.propagate_in_video()))

    pred.reset_state()
    _, m1 = pred.add_new_points_or_box(1, obj_id=1, box=np.array([5, 5, 35, 30]))
    _, m2 = pred.add_new_points_or_box(1, obj_id=2, points=np.array([[45.0, 30.0], [10.0, 8.0]]),
                                       labels=np.array([1, 0]))
    res["box/mask1"], res["box/mask2"] = np.asarray(m1), np.asarray(m2)
    record("box", list(pred.propagate_in_video(max_frame_num_to_track=2)))

    pred.init_state(FRAMES[:3])
    oid, logits = pred.add_new_mask(0, obj_id=3, mask=MASK)
    res["mask/logits"] = np.asarray(logits)
    record("mask", list(pred.propagate_in_video()))
    return res


def jax_reference():
    from sam3_lora_tpu.tracking_predictor import Sam3TrackerPredictor as JPredictor

    jproc, specs = jax_tiny_processor()
    tparams, tspecs = jax_video_tracker(jproc, NM, NP)
    pred = JPredictor(jproc, tracker_params=tparams, num_slots=K, num_maskmem=NM, max_obj_ptrs=NP)
    return specs, tspecs, session(pred)


def port_predictor(specs, tspecs):
    return Sam3TrackerPredictor(port_tiny_processor(specs),
                                tracker_params=nested(fill_params(tspecs, seed=1)),
                                num_slots=K, num_maskmem=NM, max_obj_ptrs=NP)


def check_against(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        field = k.rsplit("/", 1)[-1]
        if v.dtype.kind in "biu" or field in DISCRETE:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL, err_msg=k)


def _load():
    specs, arrays = load_reference(REF)
    n = int(arrays.pop("n_processor_params"))
    return specs[:n], specs[n:], arrays


@pytest.fixture(scope="module")
def ref():
    return _load()


def test_tracking_predictor_matches_jax(ref):
    specs, tspecs, want = ref
    got = session(port_predictor(specs, tspecs))
    check_against(got, want)
    # the sessions do what they are meant to: ring eviction, two objects,
    # the cond memory, the mask-as-output logits
    assert want["click/frames"].tolist() == [0, 1, 2, 3, 4]
    age = want["click/state/maskmem_age"][0]
    assert age[0] >= 0 and (age[1:] >= 0).all() and (age[1:] < NM - 1).all()
    assert want["box/frames"].tolist() == [1, 2] and want["box/0/ids"].tolist() == [1, 2]
    assert want["mask/logits"].max() > 0 and want["mask/logits"].min() < -5


def test_errors_and_slot_limit(ref):
    specs, tspecs, _ = ref
    pred = port_predictor(specs, tspecs)
    with pytest.raises(RuntimeError, match="init_state"):
        pred.add_new_points_or_box(0, 1, points=np.zeros((1, 2)), labels=np.ones(1))
    pred.init_state(FRAMES[:1])
    with pytest.raises(RuntimeError, match="add objects"):
        list(pred.propagate_in_video())
    for i in range(K):
        pred.add_new_mask(0, obj_id=10 + i, mask=MASK)
    with pytest.raises(RuntimeError, match=f"more than {K} objects"):
        pred.add_new_mask(0, obj_id=99, mask=MASK)
    assert isinstance(pred._state.track, TrackState)


def test_frame_features_are_cached(ref, monkeypatch):
    specs, tspecs, _ = ref
    pred = port_predictor(specs, tspecs)
    calls = []
    orig = pred.proc.set_image
    monkeypatch.setattr(pred.proc, "set_image", lambda im: calls.append(1) or orig(im))
    pred.init_state(FRAMES[:3])
    pred.add_new_points_or_box(0, obj_id=1, points=np.array([[30.0, 20.0]]), labels=np.array([1]))
    pred.add_new_points_or_box(0, obj_id=2, box=np.array([5, 5, 35, 30]))
    list(pred.propagate_in_video())
    assert len(calls) == 3  # one backbone pass per frame


def test_reference_is_current():
    specs, tspecs, live = jax_reference()
    s_specs, s_tspecs, want = _load()
    same = lambda a, b: [(".".join(p), tuple(s)) for p, s in a] == \
        [(".".join(p), tuple(s)) for p, s in b]  # noqa: E731
    assert same(specs, s_specs) and same(tspecs, s_tspecs)
    assert sorted(live) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(live[k], want[k], err_msg=k)
    check_against(session(port_predictor(specs, tspecs)), live)


if __name__ == "__main__":
    specs, tspecs, res = jax_reference()
    res["n_processor_params"] = np.asarray(len(specs))
    print(save_reference(REF, list(specs) + list(tspecs), res))
