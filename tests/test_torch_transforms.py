"""The port's augmentation pipeline (``sam3_lora_tpu_torch/train/transforms.py``)
against the JAX package's: the module is a copy, statement for statement
(``code_of``), and each pipeline of ``tests/test_transforms.py`` (its 23
cases) gives equal outputs on the same seeded datapoints and draws: images,
boxes, masks, prompts and every other field, value for value and dtype for
dtype."""

import dataclasses

import numpy as np
import pytest

from sam3_lora_tpu.train import transforms as JT
from sam3_lora_tpu_torch.train import transforms as PT

from torch_port_helpers import code_of


def test_transforms_are_a_copy():
    assert code_of(JT) == code_of(PT)
    assert JT.__all__ == PT.__all__


def make_dp(T, h=60, w=80, n_obj=3, seed=0, with_masks=True):
    """``tests/test_transforms.py::make_dp`` on module ``T``."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    boxes, masks = [], []
    for _ in range(n_obj):
        bw = rng.randint(8, w // 2)
        bh = rng.randint(8, h // 2)
        x = rng.randint(0, w - bw)
        y = rng.randint(0, h - bh)
        boxes.append([x, y, x + bw, y + bh])
        m = np.zeros((h, w), np.uint8)
        m[y: y + bh, x: x + bw] = 1
        masks.append(m)
    q = T.Query(text="crack", boxes=np.array(boxes, np.float32),
                masks=np.stack(masks) if with_masks else None, is_crowd=np.zeros((n_obj,), bool))
    return T.Datapoint(image=img, queries=[q], coco_image_id=7, original_size=(h, w))


def crop_outside(T):
    dp = make_dp(T, h=100, w=100, n_obj=1)
    x0, _, x1, _ = dp.queries[0].boxes[0]
    if x0 >= 30:
        return T.crop_datapoint(dp, 0, 0, 100, int(x0) - 1)
    return T.crop_datapoint(dp, 0, int(x1) + 1, 100, 100 - int(x1) - 1)


def random_size_crop(T):
    rng = np.random.RandomState(0)
    t = T.RandomSizeCrop(20, 40, respect_boxes=True)
    return [t(make_dp(T, h=100, w=100, seed=seed), rng) for seed in range(5)]


def mosaic(T):
    it = iter([make_dp(T, seed=s) for s in (1, 2, 3)])
    return T.RandomMosaic(lambda r: next(it), size=128, p=1.0)(make_dp(T, seed=0),
                                                                np.random.RandomState(3))


def noise_boxes(T):
    rng = np.random.RandomState(0)
    box = np.array([10, 10, 50, 40], np.float32)
    return [T.noise_box(box, (60, 80), std=0.2, max_shift=20, rng=rng) for _ in range(20)]


def randomize_input_boxes(T):
    dp = make_dp(T)
    q = dp.queries[0]
    dp.queries[0] = T.Query(text=q.text, boxes=q.boxes, masks=q.masks,
                            input_boxes=q.boxes[:1].copy())
    return T.RandomizeInputBoxes(std=0.3)(dp, np.random.RandomState(1))


def filter_crowds(T):
    dp = make_dp(T, n_obj=3)
    dp.queries[0].is_crowd[1] = True
    return T.FilterCrowds()(dp)


def filter_empty(T):
    dp = make_dp(T)
    dp.queries += [T.Query(text="dog", boxes=np.zeros((0, 4), np.float32), is_exhaustive=False),
                   T.Query(text="cat", boxes=np.zeros((0, 4), np.float32), is_exhaustive=True)]
    return [T.FilterEmptyTargets(keep_negatives=k)(dp) for k in (True, False)]


def keep_max_num_queries(T):
    dp = make_dp(T)
    dp.queries = dp.queries * 5
    return T.KeepMaxNumQueries(2)(dp, np.random.RandomState(0))


def train_pipeline(T):
    rng = np.random.RandomState(0)
    t = T.train_transforms(img_size=112, hflip=True, color_jitter=True,
                           scale_jitter=[1.0, 1.25, 1.5])
    return [t(make_dp(T, h=90, w=130, seed=seed), rng) for seed in range(3)]


def compose_deterministic(T):
    t = T.train_transforms(img_size=64)
    dp = make_dp(T)
    return [t(dp, np.random.RandomState(42)), t(dp, np.random.RandomState(42))]


RS = np.random.RandomState
CASES = {
    "resize_square_geometry": lambda T: T.resize_datapoint(make_dp(T), 100, square=True),
    "resize_aspect_preserving_max_size": lambda T: T.resize_datapoint(
        make_dp(T, h=60, w=120), 100, max_size=150),
    "hflip_involution": lambda T: T.hflip_datapoint(T.hflip_datapoint(make_dp(T))),
    "hflip_boxes_match_masks": lambda T: T.hflip_datapoint(make_dp(T)),
    "crop_drops_outside_objects": crop_outside,
    "crop_clips_boxes_to_window": lambda T: T.crop_datapoint(make_dp(T, h=100, w=100),
                                                             10, 10, 50, 50),
    "random_size_crop_respects_boxes": random_size_crop,
    "pad_to_size": lambda T: T.PadToSize(100)(make_dp(T, h=60, w=80), RS(0)),
    "color_jitter_image_only": lambda T: T.ColorJitter()(make_dp(T), RS(0)),
    "grayscale_channels_equal": lambda T: T.RandomGrayscale(p=1.0)(make_dp(T), RS(0)),
    "mosaic_merges_same_text": mosaic,
    "normalize_to_tensor": lambda T: T.NormalizeToTensor()(make_dp(T)),
    "noise_box_bounds": noise_boxes,
    "randomize_input_boxes": randomize_input_boxes,
    "sample_points_inside_mask": lambda T: T.SamplePointsFromMasks(n_points=2, mode="uniform")(
        make_dp(T), RS(0)),
    "sample_points_center_mode": lambda T: T.SamplePointsFromMasks(n_points=1, mode="center")(
        make_dp(T, n_obj=1), RS(0)),
    "filter_crowds": filter_crowds,
    "filter_empty_targets": filter_empty,
    "filter_too_many_out": lambda T: [T.FilterQueriesWithTooManyOut(max_objects=m)(
        make_dp(T, n_obj=3)) for m in (2, 3)],
    "keep_max_num_queries": keep_max_num_queries,
    "text_query_to_visual": lambda T: T.TextQueryToVisual(p=1.0)(make_dp(T), RS(0)),
    "train_pipeline_end_to_end": train_pipeline,
    "compose_deterministic_given_rng": compose_deterministic,
}


def plain(x):
    """A pipeline's output as nested lists, dicts and arrays (a dataclass as
    its class name and fields), so the two modules' outputs compare."""
    if dataclasses.is_dataclass(x):
        return {"class": type(x).__name__,
                **{f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def assert_same(got, want, where="out"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


def test_cases_are_those_of_the_jax_tests():
    import test_transforms

    names = sorted(n[len("test_"):] for n in dir(test_transforms) if n.startswith("test_"))
    assert names == sorted(CASES) and len(CASES) == 23


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_jax(case):
    want, got = plain(CASES[case](JT)), plain(CASES[case](PT))
    assert want  # every case yields something to compare
    assert_same(got, want)
