"""The port's validate CLI (``sam3_lora_tpu_torch/cli/validate.py``) against
the JAX package's ``cli.validate.main``, on one synthetic COCO split.

Both engines are replaced by stubs that return the same seeded model
outputs (scores with ties, presence, boxes, mask probabilities of
overlapping boxes and duplicates, so that the threshold, NMS, the empty
filter, top-100 and the merge all have work), and both CLIs read the same
files, so every step after the forward is compared: the result dicts must
be equal, keys and order included (tolerance 0), with and without
``--merge``, ``--tide`` and ``--dump-preds`` (the dump files equal byte for
byte). One real run of the port's CLI on the tiny model on the CPU gives
finite metrics in [0, 1] under the JAX CLI's keys."""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("yaml")

import sam3_lora_tpu.inference as jax_inference  # noqa: E402
import sam3_lora_tpu_torch.inference as port_inference  # noqa: E402
from sam3_lora_tpu.cli import validate as jax_validate  # noqa: E402
from sam3_lora_tpu_torch.cli import validate as port_validate  # noqa: E402
from sam3_lora_tpu_torch.config import tiny_model_config  # noqa: E402
from sam3_lora_tpu_torch.train.data import make_synthetic_coco  # noqa: E402


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    make_synthetic_coco(str(root), "valid", num_images=6, img_size=64)
    cfg = root / "cfg.yaml"
    cfg.write_text("model: {tiny: true}\nlora: {rank: 4, alpha: 8.0, target_modules: [qkv]}\n")
    return str(root / "valid"), str(cfg)


def seeded_outputs(call: int, image: np.ndarray):
    """The model outputs of the ``call``-th forward on ``image`` (3, R, R):
    (scores (1, Q), presence (1,), boxes (1, Q, 4), mask probabilities (1,
    Q, m, m)). The first queries are the image's bright rectangles (its
    objects) at the mask resolution, one each; the rest are seeded boxes,
    some empty."""
    from scipy import ndimage

    cfg = tiny_model_config()
    q, m = cfg.num_queries, cfg.mask_loss_resolution
    rng = np.random.RandomState(100 + call)
    scores = (rng.randint(0, 9, q) / 8).astype(np.float32)[None]  # ties, and 0.25 / 0.375
    probs = np.full((q, m, m), 0.1, np.float32)
    x = np.asarray(image, np.float32)[0]
    idx = ((np.arange(m) + 0.5) * x.shape[0] / m).astype(int)
    objects, n_obj = ndimage.label((x > (x.max() + x.min()) / 2)[np.ix_(idx, idx)])
    for j in range(n_obj):
        probs[j][objects == j + 1] = 0.9
        scores[0, j] = 0.875
    for i in range(n_obj, q):
        if i % 5 == 4:
            continue  # an empty mask
        y0, x0 = rng.randint(0, m - 3, 2)
        h, w = rng.randint(3, m // 2, 2)
        probs[i, y0:y0 + h, x0:x0 + w] = 0.9
    probs[1] = probs[0]  # a duplicate of the objects' mask
    probs[3, :, : m // 2] = np.maximum(probs[3, :, : m // 2], probs[2, :, : m // 2])
    presence = rng.rand(1).astype(np.float32)
    boxes = rng.rand(1, q, 4).astype(np.float32)
    return scores, presence, boxes, probs[None]


class _Stub:
    def __init__(self, *a, **k):
        self.cfg = tiny_model_config()
        self.device = torch.device("cpu")
        self.params = None
        self.calls = 0

    def tokenizer(self, texts, context_length):
        return np.zeros((len(texts), context_length), np.int32)

    def _next(self, images):
        self.calls += 1
        return seeded_outputs(self.calls - 1, np.asarray(images)[0])


class JaxStub(_Stub):
    def _forward(self, params, images, token_ids):
        return self._next(images)


class PortStub(_Stub):
    def _forward(self, images, token_ids):
        return tuple(torch.from_numpy(x) for x in self._next(images.numpy()))


@pytest.fixture
def stubs(monkeypatch):
    monkeypatch.setattr(jax_inference, "SAM3LoRAInference", JaxStub)
    monkeypatch.setattr(port_inference, "SAM3LoRAInference", PortStub)


@pytest.mark.parametrize("flags", [[], ["--merge"], ["--tide"], ["--merge", "--tide"],
                                   ["--dump-preds"], ["--prob-threshold", "0.0", "--nms-iou",
                                                      "0.3", "--num-samples", "4"]])
def test_result_dict_equals_jax(split, stubs, tmp_path, flags, capsys):
    val_dir, cfg = split
    argv = ["--config", cfg, "--use-base-model", "--val_data_dir", val_dir]
    results = []
    for name, mod in (("jax", jax_validate), ("port", port_validate)):
        extra = [f if f != "--dump-preds" else f"--dump-preds={tmp_path / name}" for f in flags]
        out = tmp_path / f"{name}.json"
        results.append(mod.main(argv + extra + ["--output-json", str(out)]
                                + (["--device", "cpu"] if name == "port" else [])))
        assert json.loads(out.read_text()) == json.loads(json.dumps(results[-1]))
    want, got = results
    assert list(got) == list(want) and got == want
    assert got["mAP"] > 0  # the stubs' masks hit some ground truth
    if "--dump-preds" in flags:
        a = (tmp_path / "jax" / "predictions.jsonl").read_bytes()
        assert a and a == (tmp_path / "port" / "predictions.jsonl").read_bytes()


def test_merge_overlapping_masks_equals_jax():
    rng = np.random.RandomState(0)
    masks = rng.rand(9, 12, 12) > 0.6
    masks[4] = masks[3]
    scores = (rng.randint(0, 4, 9) / 4).astype(np.float32)
    for thr in (0.15, 0.5):
        gm, gs = port_validate.merge_overlapping_masks(masks, scores, thr)
        wm, ws = jax_validate.merge_overlapping_masks(masks, scores, thr)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gs, ws)
    empty = np.zeros((0, 12, 12), bool)
    assert port_validate.merge_overlapping_masks(empty, scores[:0], 0.15)[0] is empty


def test_tiny_model_run_on_the_cpu(split, tmp_path):
    """The port's CLI end to end on the tiny model: finite metrics in
    [0, 1], the JAX CLI's keys in its order, and the dump."""
    val_dir, cfg = split
    res = port_validate.main(["--config", cfg, "--use-base-model", "--val_data_dir", val_dir,
                              "--device", "cpu", "--prob-threshold", "0.0", "--tide",
                              "--dump-preds", str(tmp_path / "dump")])
    keys = ["num_images", "mAP", "mAP_50", "mAP_75", "cgF1", "cgF1_50", "cgF1_75",
            "precision", "recall", "IL_F1", "IL_MCC", "prob_threshold", "nms_iou", "merged",
            "n_Loc", "n_Dup", "n_Bkg", "n_Miss", "n_TP", "dAP_Loc", "dAP_Dup", "dAP_Bkg",
            "dAP_Miss"]
    assert list(res) == keys and res["num_images"] == 6
    for k in ("mAP", "mAP_50", "mAP_75", "cgF1"):
        assert np.isfinite(res[k]) and 0.0 <= res[k] <= 1.0, k
    assert (tmp_path / "dump" / "predictions.jsonl").stat().st_size > 0
