"""The port's reference-checkpoint converter (``sam3_lora_tpu_torch/cli/
convert_checkpoint.py``, no JAX) against the JAX package's script
(``scripts/convert_checkpoint.py``), on the tiny config, unscanned and with
``vit_scan_blocks``:

* the copied functions and tables are the script's, statement for
  statement (``code_of``);
* ``utils/checkpoint.py::base_param_shapes`` (from a ``meta`` model) equals
  the script's ``our_param_shapes`` (JAX ``eval_shape``) and the shapes of
  ``base_params_to_jax``;
  the script's shapes are stored in ``tests/data/torch_ref_convert_shapes.json``
  (``test_stored_shapes_are_current`` recomputes them; rewrite:
  ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_convert_checkpoint.py``);
* a reference-named state dict, built from a seeded JAX-layout tree by
  ``chip_smoke.reference_state_dict`` (the inverse of ``_ref_to_ours_key``
  and of the layout transposes, with tensors the converter must skip),
  converts to the script's arrays key for key and byte for byte, and back
  to the tree it came from; unscanned, the same keys under ``detector.``
  too;
* the port's model loaded from it (``load_reference_state_dict``, or the
  converted ``.npz`` through ``load_base_checkpoint``) equals the model
  ``load_jax_params`` gives on the tree, bit for bit;
* the CLI's ``.npz`` equals the script's ``main()`` output on the same
  ``.pt``, member for member;
* a bf16 ``.pt``: the port widens it to fp32 (exact); the script raises
  (numpy has no bf16)."""

import fnmatch
import importlib.util
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import chip_smoke
from sam3_lora_tpu.config import tiny_model_config as jax_tiny
from sam3_lora_tpu_torch.cli import convert_checkpoint as port
from sam3_lora_tpu_torch.config import tiny_model_config
from sam3_lora_tpu_torch.models import build_sam3_image_model, init_model
from sam3_lora_tpu_torch.utils.checkpoint import (
    base_param_shapes, base_params_to_jax, load_base_checkpoint, load_jax_params)

from torch_port_helpers import code_of, fill_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_convert_checkpoint", os.path.join(ROOT, "scripts", "convert_checkpoint.py"))
script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script)

COPIED = ("_ref_to_ours_key", "convert_tensor", "vit_scan_map", "_stack_scanned",
          "convert_state_dict")
CASES = {"unscanned": dict(vit_scan_blocks=False), "scanned": {}}


def test_copies_equal_the_script():
    for name in COPIED:
        assert code_of(getattr(port, name)) == code_of(getattr(script, name)), name
    assert port.SKIP_PATTERNS == script.SKIP_PATTERNS and port.RENAMES == script.RENAMES


SHAPES = os.path.join(ROOT, "tests", "data", "torch_ref_convert_shapes.json")


def jax_shapes():
    """{case: the script's ``our_param_shapes`` of the tiny config} (JAX
    ``eval_shape``, a few seconds)."""
    return {case: script.our_param_shapes(jax_tiny(**kw)) for case, kw in CASES.items()}


def write_shapes(path: str = SHAPES) -> str:
    with open(path, "w") as f:
        json.dump({case: {k: list(v) for k, v in shapes.items()}
                   for case, shapes in jax_shapes().items()}, f, indent=0, sort_keys=True)
    return path


def stored_shapes():
    with open(SHAPES) as f:
        return {case: {k: tuple(v) for k, v in shapes.items()}
                for case, shapes in json.load(f).items()}


def test_stored_shapes_are_current():
    assert stored_shapes() == jax_shapes()


@pytest.fixture(scope="module", params=list(CASES))
def tree(request):
    """(case, port config, the script's shapes, a seeded JAX-layout tree of
    those shapes, its reference-named state dict)."""
    overrides = CASES[request.param]
    shapes = stored_shapes()[request.param]
    flat = fill_params(sorted((tuple(k.split(".")), v) for k, v in shapes.items()))
    cfg = tiny_model_config(**overrides)
    return request.param, cfg, shapes, flat, chip_smoke.reference_state_dict(flat, cfg)


def scan_map(cfg):
    return script.vit_scan_map(cfg) if cfg.vit_scan_blocks else None


def test_base_param_shapes(tree):
    _, cfg, shapes, _, _ = tree
    assert base_param_shapes(build_sam3_image_model(cfg, device="meta")) == shapes
    model = init_model(build_sam3_image_model(cfg), torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in base_params_to_jax(model).items()} == shapes


def assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_convert_matches_the_script(tree):
    case, cfg, shapes, flat, sd = tree
    assert any(k.startswith("transformer.decoder.boxRPB_embed_x.") for k in sd)
    assert any(k.endswith(".attn.freqs_cis") for k in sd)
    meta = build_sam3_image_model(cfg, device="meta")
    got = port.convert_for_model(meta, sd)
    want = script.convert_state_dict({k: v.numpy() for k, v in sd.items()}, shapes,
                                     scan_map=scan_map(cfg))
    assert_same_arrays(got, want)
    assert_same_arrays(got, flat)  # the inverse is one
    if case == "unscanned":  # keys under ``detector.``, which both strip
        prefixed = {"detector." + k: v for k, v in sd.items()
                    if not any(fnmatch.fnmatch(k, p) for p in port.SKIP_PATTERNS)}
        assert_same_arrays(port.convert_for_model(meta, prefixed), want)
        assert_same_arrays(script.convert_state_dict(
            {k: v.numpy() for k, v in prefixed.items()}, shapes), want)


def test_loaded_model_matches_load_jax_params(tree, tmp_path):
    _, cfg, _, flat, sd = tree
    ref = build_sam3_image_model(cfg)
    load_jax_params(ref, flat)
    want = dict(ref.named_parameters())
    direct = build_sam3_image_model(cfg)
    assert port.load_reference_state_dict(direct, {"model": sd}) == len(want)
    path = str(tmp_path / "base.npz")
    np.savez(path, **port.convert_for_model(direct, sd))
    from_file = build_sam3_image_model(cfg)
    load_base_checkpoint(from_file, path)
    for model in (direct, from_file):
        got = dict(model.named_parameters())
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], p) for k, p in want.items())


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_cli_matches_the_script(tmp_path, monkeypatch, capsys):
    """``--tiny`` is the scanned tiny config in both; the script's JAX shape
    table is the stored one (``test_stored_shapes_are_current``)."""
    shapes = stored_shapes()["scanned"]
    monkeypatch.setattr(script, "our_param_shapes", lambda cfg=None: shapes)
    flat = fill_params(sorted((tuple(k.split(".")), v) for k, v in shapes.items()))
    pt = str(tmp_path / "sam3.pt")
    torch.save({"model": chip_smoke.reference_state_dict(flat, tiny_model_config())}, pt)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port.main(["--torch-ckpt", pt, "--out", ours, "--tiny"])
    monkeypatch.setattr("sys.argv", ["convert_checkpoint.py", "--torch-ckpt", pt, "--out",
                                     theirs, "--tiny"])
    script.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"converted {len(flat)} tensors -> {ours}",
                     f"converted {len(flat)} tensors -> {theirs}"]
    assert _members(ours) == _members(theirs)


def test_bf16_checkpoint(tmp_path, monkeypatch):
    """The port widens bf16 to fp32 (exact); the script's ``.numpy()`` raises
    on a bf16 tensor (a fault of the reference script, ROADMAP.md section 3)."""
    cfg = tiny_model_config()
    flat = fill_params(sorted((tuple(k.split(".")), v)
                              for k, v in base_param_shapes(build_sam3_image_model(
                                  cfg, device="meta")).items()))
    sd = chip_smoke.reference_state_dict(flat, cfg)
    pt = str(tmp_path / "sam3_bf16.pt")
    torch.save({k: v.bfloat16() for k, v in sd.items()}, pt)
    out = str(tmp_path / "port.npz")
    port.main(["--torch-ckpt", pt, "--out", out, "--tiny"])
    widened = port.convert_for_model(build_sam3_image_model(cfg, device="meta"),
                                     {k: v.bfloat16().float() for k, v in sd.items()})
    with np.load(out) as data:
        assert_same_arrays({k: data[k] for k in data.files}, widened)
    monkeypatch.setattr(script, "our_param_shapes", lambda cfg=None: stored_shapes()["scanned"])
    monkeypatch.setattr("sys.argv", ["convert_checkpoint.py", "--torch-ckpt", pt, "--out",
                                     str(tmp_path / "jax.npz"), "--tiny"])
    with pytest.raises(TypeError):
        script.main()


if __name__ == "__main__":
    print(write_shapes())
