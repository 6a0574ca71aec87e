"""The port's own config dataclasses equal the JAX package's: field names,
defaults, ``tiny_model_config()``, the methods, and ``load_yaml_config`` on
a sample YAML. And the port's entry points ask for the card unless told to
use the CPU: without a card they raise the CUDA error."""

import dataclasses

import pytest
import torch

import sam3_lora_tpu.config as jc
import sam3_lora_tpu_torch.config as tc


@pytest.mark.parametrize("name", ["ModelConfig", "LoRAConfig", "TrainConfig"])
def test_dataclass_fields_and_defaults_equal_jax(name):
    a, b = getattr(jc, name), getattr(tc, name)
    fa = [(f.name, f.default, f.default_factory, f.type) for f in dataclasses.fields(a)]
    fb = [(f.name, f.default, f.default_factory, f.type) for f in dataclasses.fields(b)]
    assert fa == fb
    assert a.__dataclass_params__.frozen == b.__dataclass_params__.frozen
    assert dataclasses.asdict(a()) == dataclasses.asdict(b())


def test_tiny_config_and_methods_equal_jax():
    for kw in ({}, {"base_quant": "int8", "base_quant_min_dim": 16}):
        assert dataclasses.asdict(jc.tiny_model_config(**kw)) == dataclasses.asdict(tc.tiny_model_config(**kw))
    a, b = jc.ModelConfig(), tc.ModelConfig()
    assert (a.feat_size, a.vit_mlp_hidden) == (b.feat_size, b.vit_mlp_hidden) == (72, 4736)
    assert dataclasses.asdict(a.replace(vit_dim=64)) == dataclasses.asdict(b.replace(vit_dim=64))
    la, lb = jc.LoRAConfig(rank=4, alpha=8.0), tc.LoRAConfig(rank=4, alpha=8.0)
    assert la.scaling == lb.scaling == 2.0
    for name in ("vision_encoder.trunk.blocks.0.attn.qkv", "detr_decoder.layers.1.out_proj",
                 "text_encoder.x.mlp.c_fc", "geometry_encoder.final_proj", "q_proj"):
        assert la.should_apply(name) == lb.should_apply(name)
    d = {"rank": 16, "alpha": 32, "target_modules": ["qkv", "fc1"], "unknown": 1}
    assert jc.LoRAConfig.from_dict(d).to_dict() == tc.LoRAConfig.from_dict(d).to_dict()


def test_load_yaml_config_equals_jax(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "model: {tiny: true, base_quant: int8, base_quant_min_dim: 16}\n"
        "lora: {rank: 4, alpha: 8.0, dropout: 0.1, target_modules: [qkv, fc1]}\n"
        "training: {batch_size: 2, learning_rate: '5e-5', weight_decay: 0.01, num_epochs: 3}\n"
        "output: {output_dir: /tmp/x}\n"
    )
    a, b = jc.load_yaml_config(str(path)), tc.load_yaml_config(str(path))
    assert a == b
    assert dataclasses.asdict(jc.TrainConfig.from_yaml_dict(a)) == dataclasses.asdict(
        tc.TrainConfig.from_yaml_dict(b))
    from sam3_lora_tpu_torch.cli.train import model_config_from_yaml

    assert model_config_from_yaml(b["model"]) == tc.tiny_model_config(base_quant="int8",
                                                                       base_quant_min_dim=16)
    assert model_config_from_yaml({"dtype": "float32"}) == tc.ModelConfig(dtype="float32")


@pytest.mark.parametrize("entry", ["trainer", "inference", "processor", "predictor",
                                   "video_grounder", "video_predictor", "tracker_predictor"])
def test_entry_points_default_to_the_card(entry):
    """With no device, ``Trainer``, ``SAM3LoRAInference``, ``Sam3Processor``
    and, on a default processor, ``SAM3InteractiveImagePredictor``,
    ``VideoGrounder``, ``Sam3VideoPredictor`` and ``Sam3TrackerPredictor``
    build on CUDA: on a host without a card that raises (nothing falls back
    to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is then simply usable")
    if entry == "trainer":
        from sam3_lora_tpu_torch.train.trainer import Trainer as cls
    elif entry == "inference":
        from sam3_lora_tpu_torch.inference import SAM3LoRAInference as cls
    elif entry == "processor":
        from sam3_lora_tpu_torch.processor import Sam3Processor as cls
    else:
        from sam3_lora_tpu_torch.predictor import SAM3InteractiveImagePredictor
        from sam3_lora_tpu_torch.processor import Sam3Processor
        from sam3_lora_tpu_torch.tracking_predictor import Sam3TrackerPredictor
        from sam3_lora_tpu_torch.video import VideoGrounder
        from sam3_lora_tpu_torch.video_predictor import Sam3VideoPredictor

        outer = {"predictor": SAM3InteractiveImagePredictor, "video_grounder": VideoGrounder,
                 "video_predictor": Sam3VideoPredictor,
                 "tracker_predictor": Sam3TrackerPredictor}[entry]

        def cls(cfg):
            return outer(Sam3Processor(cfg))
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        cls(tc.tiny_model_config())


@pytest.mark.parametrize("cli", ["train", "infer", "validate", "compare", "video"])
def test_clis_default_to_the_card(cli, tmp_path):
    """``--device`` defaults to cuda in every CLI (parsed, not run)."""
    import argparse

    from sam3_lora_tpu_torch.cli import compare, infer, train, validate, video

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        ns = orig(self, args, namespace)
        seen["device"] = ns.device
        raise SystemExit(0)

    argv = ["--config", "x.yaml"] + {
        "train": [], "infer": ["--image", "x.png"], "validate": ["--val_data_dir", "v"],
        "compare": ["--weights", "w.npz", "--val_data_dir", "v"],
        "video": ["--video", "v.mp4", "--prompt", "crack"]}[cli]
    mod = {"train": train, "infer": infer, "validate": validate, "compare": compare,
           "video": video}[cli]
    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", spy)
    try:
        with pytest.raises(SystemExit):
            mod.main(argv)
    finally:
        mp.undo()
    assert seen["device"] == "cuda"
