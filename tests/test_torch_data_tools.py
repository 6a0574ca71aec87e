"""The port's dataset tools (``sam3_lora_tpu_torch/cli/check_text_encoding.py``,
``verify_gt_transforms.py``, ``analyze_loss.py``) against the JAX package's
scripts of the same names, on a synthetic COCO set (three categories, one
cut off by the tiny config's 8-token context) and the tiny config, with the
same weights on both sides (the scripts' random inits replaced by one tree
filled from numpy, through the weight bridge) and every dropout off (the
scorer MLP's fixed 0.1 too: the two packages draw their masks from
different generators, as in ``test_torch_train_step.py``):

* check_text_encoding: the printed lines and the exit code equal the
  script's; with ``--encode`` (the text encoder, here on the CPU) equal to
  the script's stored lines;
* verify_gt_transforms, plain and ``--augment``: the printed lines equal;
  the overlays are drawn on the samples' images (the script's turn white:
  it maps the uint8 image back as if it were normalized);
* analyze_loss: the weight breakdown's lines equal the script's; with
  ``--measure`` every loss within the slice tests' fp32 tolerance (2e-4
  relative, plus one unit of the printed 3 decimals) of the script's
  stored values.

The scripts' ``--encode`` and ``--measure`` runs (un-jitted JAX: ~10 s and
~75 s) are stored in ``tests/data/torch_ref_data_tools.json``, written by
running the scripts: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_data_tools.py``. ``test_reference_is_current`` (slow)
reruns ``--encode``; ``--measure`` is left to the rewrite, for its time."""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
from PIL import Image

from sam3_lora_tpu_torch import models as port_models
from sam3_lora_tpu_torch.cli import analyze_loss, check_text_encoding, verify_gt_transforms
from sam3_lora_tpu_torch.train.data import make_synthetic_coco
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import fill_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "tests", "data", "torch_ref_data_tools.json")
SHAPES = os.path.join(ROOT, "tests", "data", "torch_ref_convert_shapes.json")
CATEGORIES = ("wall stain", "a long category name that the tiny context cuts off")
TOL = 2e-4
DATA = "<data>"


def script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_weights():
    """The tiny base model's JAX names and shapes (the converter's stored
    table), filled from numpy seed 0."""
    with open(SHAPES) as f:
        shapes = json.load(f)["scanned"]
    return fill_params(sorted((tuple(k.split(".")), tuple(v)) for k, v in shapes.items()))


def synthetic(tmp):
    return make_synthetic_coco(str(tmp), "train", num_images=4, img_size=64,
                               extra_categories=CATEGORIES)


def run(main, argv, capsys, root=None):
    code = main(argv)
    out = capsys.readouterr().out
    return code, (out.replace(root, DATA) if root else out).splitlines()


@pytest.fixture
def port_weights(monkeypatch):
    """The port's ``init_model`` loads ``tiny_weights`` instead, and turns
    the scorer MLP's dropout off."""
    flat = tiny_weights()

    def init(model, g):
        load_jax_params(model, flat)
        model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0
        return model

    monkeypatch.setattr(port_models, "init_model", init)


def _mlp_without_dropout(*args, dropout=0.0, **kwargs):
    from sam3_lora_tpu.models import layers as jax_layers

    return jax_layers.MLP(*args, dropout=0.0, **kwargs)


def jax_with_weights(mp):
    """The JAX package's inits (``init_model_fast``, ``init_model``) give
    ``tiny_weights`` instead, and the scorer MLP has no dropout."""
    import jax.numpy as jnp
    from flax import traverse_util

    import sam3_lora_tpu.models as jax_models
    from sam3_lora_tpu.config import tiny_model_config
    from sam3_lora_tpu.models.builder import dummy_batch

    from torch_port_helpers import param_specs

    cfg = tiny_model_config()
    flat = tiny_weights()  # by '.'-joined name; the tree's paths from eval_shape
    specs = param_specs(jax_models.build_sam3_image_model(cfg), dummy_batch(cfg), train=False)
    tree = traverse_util.unflatten_dict({p: jnp.asarray(flat[".".join(p)]) for p, _ in specs})
    mp.setattr(jax_models, "init_model_fast", lambda model, *a, **k: tree)
    mp.setattr(jax_models, "init_model", lambda model, *a, **k: tree)
    from sam3_lora_tpu.models import scoring as jax_scoring

    mp.setattr(jax_scoring, "MLP", _mlp_without_dropout)


def jax_reference(tmp, capsys, measure: bool = True):
    """The scripts' ``--encode`` (and ``--measure``) lines on the synthetic set."""
    root = synthetic(tmp)
    with pytest.MonkeyPatch.context() as mp:
        jax_with_weights(mp)
        ref = {"check_text_encoding": run(script("check_text_encoding").main,
                                          ["--data_dir", root, "--tiny", "--encode"], capsys,
                                          root)[1]}
        if measure:
            ref["analyze_loss"] = run(script("analyze_loss").main, ["--measure"], capsys)[1]
    return ref


def stored():
    with open(REF) as f:
        return json.load(f)


def test_check_text_encoding_matches_the_script(tmp_path, capsys):
    root = synthetic(tmp_path)
    argv = ["--data_dir", root, "--tiny"]
    want = run(script("check_text_encoding").main, argv, capsys, root)
    got = run(check_text_encoding.main, argv + ["--device", "cpu"], capsys, root)
    assert got == want
    assert want[0] == 1 and any("TRUNCATED!" in line for line in want[1])


def test_check_text_encoding_encode(tmp_path, capsys, port_weights):
    root = synthetic(tmp_path)
    got = run(check_text_encoding.main, ["--data_dir", root, "--tiny", "--encode",
                                         "--device", "cpu"], capsys, root)
    assert got[1] == stored()["check_text_encoding"]
    assert "text encoder output finite: True, shape (3, 8, 32)" in got[1]


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_verify_gt_transforms_matches_the_script(tmp_path, capsys, augment):
    root = synthetic(tmp_path / "data")
    out = {side: str(tmp_path / side) for side in ("port", "jax")}
    argv = ["--data_dir", root, "--tiny", "--num", "3"] + (["--augment"] if augment else [])
    want = run(script("verify_gt_transforms").main, argv + ["--out", out["jax"]], capsys)
    got = run(verify_gt_transforms.main, argv + ["--out", out["port"]], capsys)
    assert got[0] == want[0] == 0
    assert [line.replace(out["port"], "<out>") for line in got[1]] == \
        [line.replace(out["jax"], "<out>") for line in want[1]]
    for i in range(3):
        port_png = np.asarray(Image.open(os.path.join(out["port"], f"gt_{i:03d}.png")))
        jax_png = np.asarray(Image.open(os.path.join(out["jax"], f"gt_{i:03d}.png")))
        white = lambda a: (a == 255).all(axis=-1).mean()  # noqa: E731
        assert white(jax_png) > 0.5 > 0.05 > white(port_png)


def numbers(lines):
    return [float(x) for line in lines for x in re.findall(r"-?\d+\.\d+", line)]


def test_analyze_loss_matches_the_script(capsys, port_weights):
    want = run(script("analyze_loss").main, [], capsys)
    got = run(analyze_loss.main, [], capsys)
    assert got == want
    code, measured = run(analyze_loss.main, ["--measure", "--device", "cpu"], capsys)
    ref = stored()["analyze_loss"]
    assert code == 0 and len(measured) == len(ref)
    assert [re.sub(r"-?\d+\.\d+", "#", line) for line in measured] == \
        [re.sub(r"-?\d+\.\d+", "#", line) for line in ref]
    np.testing.assert_allclose(numbers(measured), numbers(ref), rtol=TOL, atol=1e-3 + 1e-9)
    assert any("core_loss" in line for line in measured)


@pytest.mark.parametrize("tool", ["check_text_encoding", "analyze_loss"])
def test_tools_run_on_the_card_by_default(tool, tmp_path, monkeypatch):
    """``--device`` defaults to cuda (parsed, not run), as in every CLI of
    the port."""
    import argparse

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen["device"] = orig(self, args, namespace).device
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    main = {"check_text_encoding": check_text_encoding.main, "analyze_loss": analyze_loss.main}
    with pytest.raises(SystemExit):
        main[tool](["--data_dir", str(tmp_path)] if tool == "check_text_encoding" else [])
    assert seen == {"device": "cuda"}


def test_reference_is_current(tmp_path, capsys):
    live = jax_reference(tmp_path, capsys, measure=False)
    assert live["check_text_encoding"] == stored()["check_text_encoding"]


if __name__ == "__main__":
    import tempfile

    class Capture:  # capsys for a run outside pytest
        def readouterr(self):
            import sys

            out = sys.stdout.getvalue()
            sys.stdout.seek(0)
            sys.stdout.truncate()
            return type("R", (), {"out": out})

    import contextlib
    import io

    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
        ref = jax_reference(d, Capture())
    with open(REF, "w") as f:
        json.dump(ref, f, indent=1)
    print(REF)
