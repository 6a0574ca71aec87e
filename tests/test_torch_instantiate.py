"""The port's ``utils/instantiate.py`` (a copy) against the JAX package's:
the same code statement for statement (syntax trees equal without the
docstrings), and the config tier driving the port: ``locate``, ``${...}``
interpolation and ``instantiate`` of ``_target_`` nodes that name the
port's classes and functions (never the JAX package's), with
``_partial_``, overrides and lists."""

import functools

import pytest

from sam3_lora_tpu.utils import instantiate as jinst
from sam3_lora_tpu_torch.config import LoRAConfig
from sam3_lora_tpu_torch.utils import instantiate as tinst
from sam3_lora_tpu_torch.utils.instantiate import instantiate, locate, resolve

from torch_port_helpers import code_of

TARGET = "sam3_lora_tpu_torch.config.LoRAConfig"


def test_copy_has_the_jax_code():
    assert code_of(jinst) == code_of(tinst)


def test_locate_class_and_nested_attr():
    assert locate(TARGET) is LoRAConfig
    fn = locate("sam3_lora_tpu_torch.ops.boxes.box_cxcywh_to_xyxy")
    assert callable(fn) and fn.__module__ == "sam3_lora_tpu_torch.ops.boxes"


def test_locate_missing_raises():
    with pytest.raises(ImportError):
        locate("sam3_lora_tpu_torch.no.such.Thing")


def test_resolve_interpolations():
    cfg = {"base": {"lr": 0.001, "name": "run1"},
           "optim": {"lr": "${base.lr}", "tag": "exp-${base.name}"},
           "a": 7, "b": "${a}", "c": "${b}"}
    out = resolve(cfg)
    assert out["optim"] == {"lr": 0.001, "tag": "exp-run1"}  # types kept, embedded as str
    assert out["c"] == 7 and out == jinst.resolve(cfg)
    with pytest.raises(RecursionError):
        resolve({"a": "${b}", "b": "${a}"})


@pytest.mark.parametrize("case", ["plain", "nested", "partial", "override", "list"])
def test_instantiate_port_targets(case):
    if case == "plain":
        obj = instantiate({"_target_": TARGET, "rank": 16, "alpha": 32.0})
        assert (obj.rank, obj.alpha) == (16, 32.0)
    elif case == "nested":
        out = instantiate({"rank": 8, "lora": {"_target_": TARGET, "rank": "${rank}",
                                               "alpha": 16.0}})
        assert out["lora"].rank == 8 and isinstance(out["lora"], LoRAConfig)
    elif case == "partial":
        fn = instantiate({"_target_": TARGET, "_partial_": True, "alpha": 64.0})
        assert isinstance(fn, functools.partial)
        obj = fn(rank=32)
        assert (obj.rank, obj.alpha) == (32, 64.0)
    elif case == "override":
        assert instantiate({"_target_": TARGET, "rank": 4}, rank=64).rank == 64
    else:
        objs = instantiate([{"_target_": TARGET, "rank": 1}, {"_target_": TARGET, "rank": 2}])
        assert [o.rank for o in objs] == [1, 2]
