"""The port's LoRA-against-base sweep (``sam3_lora_tpu_torch/cli/compare.py``)
on the tiny model on the CPU: it writes the image's figure and the
combined grid; with the adapters as built swapped back in (zero
``lora_b``), the engine's predictions equal, bit for bit, those of an
engine built without adapters on the same base weights, and with the
trained set they differ."""

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")
pytest.importorskip("yaml")

from sam3_lora_tpu_torch.cli import compare  # noqa: E402
from sam3_lora_tpu_torch.config import LoRAConfig, tiny_model_config  # noqa: E402
from sam3_lora_tpu_torch.inference import SAM3LoRAInference  # noqa: E402
from sam3_lora_tpu_torch.models.lora import save_lora_weights  # noqa: E402
from sam3_lora_tpu_torch.train.data import make_synthetic_coco  # noqa: E402

LORA = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "linear1"))


def _trained_adapters(path):
    """An adapter file with nonzero ``lora_b``: a stand-in for a trained set."""
    engine = SAM3LoRAInference(tiny_model_config(), LORA, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in engine.model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.5, generator=g)
    save_lora_weights(engine.model, str(path))
    return str(path)


def test_compare_writes_its_figures(tmp_path):
    make_synthetic_coco(str(tmp_path), "valid", num_images=1, img_size=64)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("model: {tiny: true}\n"
                   "lora: {rank: 4, alpha: 8.0, target_modules: [qkv, fc1, linear1]}\n")
    out = tmp_path / "out"
    compare.main(["--config", str(cfg), "--weights", _trained_adapters(tmp_path / "a.npz"),
                  "--val_data_dir", str(tmp_path / "valid"), "--num-images", "1",
                  "--threshold", "0.0", "--output-dir", str(out), "--device", "cpu"])
    for name in ("comparison_000.png", "combined_comparison_all.png"):
        assert (out / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name


def test_base_adapters_give_the_base_model(tmp_path):
    cfg = tiny_model_config()
    engine = SAM3LoRAInference(cfg, LORA, threshold=0.0, device="cpu")
    base = compare.adapter_tensors(engine.model)
    assert base and all(not t.any() for n, t in base.items() if n.endswith("lora_b"))
    plain = SAM3LoRAInference(cfg, None, threshold=0.0, device="cpu")
    frozen = {k: v for k, v in engine.model.state_dict().items() if k not in base}
    plain.model.load_state_dict(frozen)
    image = np.random.RandomState(0).randint(0, 256, (40, 60, 3)).astype(np.uint8)
    want = plain.predict(image, ["crack"])[0]

    engine.load_adapters(_trained_adapters(tmp_path / "a.npz"))
    trained = engine.predict(image, ["crack"])[0]
    assert not np.array_equal(trained["scores"], want["scores"])
    compare.set_adapters(engine.model, base)
    got = engine.predict(image, ["crack"])[0]
    assert got["num_detections"] == want["num_detections"] == cfg.num_queries
    for key in ("scores", "boxes", "masks"):
        np.testing.assert_array_equal(got[key], want[key])
