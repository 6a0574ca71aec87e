"""The serving forward's graph cache (``graphs.py``) where it may not
engage, what makes it drop its graphs, its bound and its counters; the
routing flags it keys on (``ops.routes()``); the geometry encoder's box
scale by Python numbers (no upload), bit for bit the float32 tensor product
it replaced. The cache's replays on the card: ``tests/test_torch_cuda.py``."""

import importlib
import pkgutil

import numpy as np
import pytest
import torch

from sam3_lora_tpu_torch import graphs, ops
from sam3_lora_tpu_torch.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu_torch.inference import SAM3LoRAInference
from sam3_lora_tpu_torch.models.builder import dummy_batch
from sam3_lora_tpu_torch.models.geometry import scale_xyxy
from sam3_lora_tpu_torch.models.layers import LoRALinear
from sam3_lora_tpu_torch.models.lora import merge_lora_into_base, save_lora_weights
from sam3_lora_tpu_torch.parallel import fsdp
from sam3_lora_tpu_torch.processor import Sam3Processor
from sam3_lora_tpu_torch.utils import logging as tl

LORA = LoRAConfig(target_modules=("qkv", "fc1"))
GRAPH_COUNTERS = ("graph_captures", "graph_replays")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("w,h", [(72, 72), (5, 3), (1, 1000)])
def test_box_scale_by_python_numbers_equals_the_tensor_product(dtype, w, h):
    g = torch.Generator().manual_seed(w * 1000 + h)
    xyxy = (torch.rand((3, 7, 4), generator=g) * 1.4 - 0.2).to(dtype)
    want = xyxy * torch.tensor([w, h, w, h], dtype=torch.float32)
    got = scale_xyxy(xyxy, w, h)
    assert got.dtype == want.dtype and got.is_contiguous() and torch.equal(got, want)


@pytest.fixture(scope="module")
def processor():
    return Sam3Processor(tiny_model_config(), LORA, device="cpu")


def _counts():
    c = tl.counters()
    return tuple(c.get(k, 0) for k in GRAPH_COUNTERS)


def test_the_cache_never_engages_on_the_cpu(processor):
    eng = processor.engine
    image = np.random.RandomState(0).randint(0, 256, (90, 120, 3), np.uint8)
    before = _counts()
    eng.predict(image, ["crack", "hole"], threshold=0.0)
    processor.set_image(image).set_text_prompt("crack", threshold=0.0)
    with torch.enable_grad():
        eng.model(dummy_batch(eng.cfg, 2, with_targets=True))
    assert _counts() == before and not eng.graphs._graphs


@pytest.fixture
def card(monkeypatch):
    """Every tensor counts as on the card: the cache's decision alone."""
    monkeypatch.setattr(graphs, "_on_card", lambda t: True)


def test_gradients_training_targets_or_a_sharded_leaf_keep_the_forward_eager(card, monkeypatch):
    eng = SAM3LoRAInference(tiny_model_config(), LORA, device="cpu")
    x = torch.zeros(1)
    with torch.no_grad():
        assert eng.graphs.engages(x)
        eng.model.train()
        assert not eng.graphs.engages(x)
        eng.model.eval()
    assert not eng.graphs.engages(x)  # gradients on
    # with targets the grounding runs eagerly: the training branch, which has no masks of
    # every query for head_outputs
    monkeypatch.setattr(graphs.GraphCache, "run", lambda *a, **k: pytest.fail("replayed"))
    batch = dummy_batch(eng.cfg, 2, with_targets=True)
    with torch.no_grad():
        feats, poss = eng.model.backbone_image(batch.images)
        with pytest.raises(KeyError, match="pred_masks"):
            eng.ground(feats, poss, batch)
    # a sharded leaf, seen by a cache's first look, or after the change by one that looked
    # before (sharding replaces the leaf by its slice)
    layer = next(m for m in eng.model.modules() if isinstance(m, LoRALinear))
    fsdp.mark(layer, "weight", fsdp.Shard(dim=0, count=2, index=0, group=None))
    with torch.no_grad():
        assert not graphs.GraphCache(eng.model).engages(x)
        layer.weight = torch.nn.Parameter(layer.weight.detach()[: layer.weight.shape[0] // 2])
        assert not eng.graphs.engages(x)


def test_a_changed_adapter_weight_route_or_load_drops_the_graphs(card, tmp_path):
    eng = SAM3LoRAInference(tiny_model_config(), LORA, device="cpu")
    cache, x = eng.graphs, torch.zeros(1)

    def dropped(change) -> bool:
        with torch.no_grad():
            assert cache.engages(x)
        cache._graphs["probe"] = None
        change()
        with torch.no_grad():
            cache.engages(x)
        return "probe" not in cache._graphs

    layers = [m for m in eng.model.modules() if isinstance(m, LoRALinear) and m.lora_a is not None]
    path = str(tmp_path / "lora.npz")
    save_lora_weights(eng.model, path)
    assert not dropped(lambda: None)
    with torch.no_grad():
        assert not dropped(lambda: layers[0].weight.add_(1.0))  # in place: the graph reads it
    # a hot swap copies into the adapters in place: the graphs read the new values and stay
    assert not dropped(lambda: eng.load_adapters(path))
    assert dropped(lambda: setattr(layers[0], "lora_a", None))
    assert dropped(lambda: merge_lora_into_base(eng.model))
    w = layers[-1].weight
    assert dropped(lambda: setattr(layers[-1], "weight", torch.nn.Parameter(w.detach().clone())))

OPS_MODULES = [importlib.import_module(f"sam3_lora_tpu_torch.ops.{m.name}")
               for m in pkgutil.iter_modules(ops.__path__)]


@pytest.mark.parametrize("mod,flag", [(m, k) for m in OPS_MODULES for k, v in vars(m).items()
                                      if isinstance(v, bool)])
def test_every_routing_flag_of_ops_is_in_the_graph_key(monkeypatch, mod, flag):
    """Each module-level flag of ``ops`` changes ``ops.routes()``, which is
    part of every graph's key: a flag missing from it would replay a stale
    route."""
    key = ops.routes()
    monkeypatch.setattr(mod, flag, not getattr(mod, flag))
    assert ops.routes() != key


class _Stub:
    """A captured unit without a card: its replay gives its inputs back."""

    def __init__(self, fn, inputs, pool):
        self.inputs = list(inputs)

    def replay(self, inputs):
        graphs.count("graph_replays")
        return list(inputs)


def test_the_cache_keeps_the_graphs_used_last_and_counts_captures_by_unit(monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", _Stub)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    cache = graphs.GraphCache(torch.nn.Linear(2, 2))
    names = ("graph_captures", "graph_captures.ground", "graph_captures.backbone",
             "graph_replays")

    def counted(calls):
        c0 = tl.counters()
        for unit, n in calls:
            out = cache.run(unit, lambda x: [x], [torch.zeros(n)])
            assert out[0].shape == (n,)
        c = tl.counters()
        return [c.get(k, 0) - c0.get(k, 0) for k in names]

    assert counted([("backbone", 1)] + [("ground", n) for n in range(2, 2 + graphs.MAX_GRAPHS)]) \
        == [1 + graphs.MAX_GRAPHS, graphs.MAX_GRAPHS, 1, 1 + graphs.MAX_GRAPHS]
    # the backbone's graph, the oldest, made room for the last prompt count
    assert len(cache._graphs) == graphs.MAX_GRAPHS
    assert counted([("ground", 3), ("backbone", 1)]) == [1, 0, 1, 2]
    # a replay makes its key the newest: the ground of 3 outlives that of 4
    assert counted([("ground", 3), ("ground", 2), ("ground", 4), ("ground", 3)]) == [2, 2, 0, 4]
