"""The port's scale-out (``sam3_lora_tpu_torch/parallel``, the group-wide
loss denominators, the host-sharded loader) against the JAX package's.

* ``HostShard`` and the loader's per-rank order equal JAX's
  (``multihost.HostShard``, ``DataLoader._host_indices``), and the copies
  of ``HostShard`` and ``filesystem_gather`` are the originals statement for
  statement;
* ``param_shardings(shard_base=True)`` names, in torch layout, the axis
  that JAX's rule splits, on the whole tiny tree (its JAX shapes stored
  with ``torch_ref_eval_bench.npz``) and on 256-wide layers (their trees from
  ``jax.eval_shape``), ties included;
* the data-parallel gradient: the stored JAX whole-batch training step
  (``tests/data/torch_ref_train.npz``: 2 images, 3 rows) split by image
  into two shards of 2 and 1 rows. Each shard's loss takes the group's
  counts (the reduction helper returns the sum of both shards' counts and a
  group of 2, in place of the collective); the mean of the two shards'
  adapter gradients equals JAX's whole-batch gradient within
  ``test_torch_train_step.py``'s 2e-3 of each gradient's largest entry, and
  shards that keep their own denominators do not;
* ``initialize`` is a no-op for one process, NCCL without a card raises;
* two real processes (slow, ~20-35 s each, by design): ``Trainer.fit``
  under a 2-rank gloo group on the tiny config over a synthetic COCO split
  (adapters equal across the ranks, within the AdamW tolerance of
  ``test_torch_train_step.py`` of one process at the whole batch, only rank
  0 writing files, the frame-parallel detector over both ranks), and
  ``cli.train`` under ``torch.distributed.run``.
"""

import ast
import inspect
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from sam3_lora_tpu.config import LoRAConfig as JLoRAConfig
from sam3_lora_tpu.config import tiny_model_config as jax_tiny_config
from sam3_lora_tpu.parallel import dist_utils as jax_dist_utils
from sam3_lora_tpu.parallel import multihost as jax_multihost
from sam3_lora_tpu.parallel import param_shardings as jax_param_shardings
from sam3_lora_tpu.train.data import DataLoader as JDataLoader
from sam3_lora_tpu_torch.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu_torch.models import build_sam3_image_model
from sam3_lora_tpu_torch.models.lora import lora_state, trainable_parameters
from sam3_lora_tpu_torch.parallel import dist_utils, make_mesh, multihost, param_shardings, shard_batch
from sam3_lora_tpu_torch.train import losses as port_losses
from sam3_lora_tpu_torch.train.data import DataLoader
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params, stack_scanned

from test_torch_reference import LORA, _batch, _load
from torch_port_helpers import fill_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 2e-3  # of each gradient's largest entry, as test_torch_train_step.py


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,count", [(103, 4), (10, 1), (8, 2), (7, 3)])
def test_host_shard_indices_equal_jax(n, count):
    for i in range(count):
        np.testing.assert_array_equal(multihost.HostShard(i, count).indices(n),
                                      jax_multihost.HostShard(i, count).indices(n))


@pytest.mark.parametrize("n,bs,count,shuffle,drop_last", [
    (8, 2, 2, True, True), (23, 3, 4, True, True), (23, 3, 4, False, False), (9, 4, 1, True, False)])
def test_loader_host_shard_order_equals_jax(n, bs, count, shuffle, drop_last):
    for i in range(count):
        kw = dict(batch_size=bs, shuffle=shuffle, seed=5, drop_last=drop_last, tokenizer=object())
        port = DataLoader(_Sized(n), host_shard=multihost.HostShard(i, count), **kw)
        ref = JDataLoader(_Sized(n), host_shard=jax_multihost.HostShard(i, count), **kw)
        assert len(port) == len(ref)
        for epoch in range(3):
            np.testing.assert_array_equal(port.order(epoch), ref._host_indices(epoch))


def _body(obj) -> str:
    """``obj``'s syntax tree without docstrings."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.body and isinstance(
                node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant):
            node.body = node.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("port,ref", [(multihost.HostShard, jax_multihost.HostShard),
                                      (dist_utils.filesystem_gather, jax_dist_utils.filesystem_gather)])
def test_copies_equal_their_originals(port, ref):
    assert _body(port) == _body(ref)


def test_single_process_helpers(tmp_path, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert (multihost.process_index(), multihost.process_count(), multihost.is_primary()) == (0, 1, True)
    assert multihost.host_shard() == multihost.HostShard(0, 1)
    assert multihost.rank_device("cuda") == torch.device("cuda", 0)
    assert multihost.rank_device("cpu") == torch.device("cpu")
    assert dist_utils.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert dist_utils.broadcast_object(3) == 3
    dist_utils.barrier()
    t = torch.arange(3.0)
    dist_utils.all_reduce_mean_([t])
    assert torch.equal(t, torch.arange(3.0))
    got = dist_utils.filesystem_gather({"x": 1}, str(tmp_path), tag="t")
    assert got == [{"x": 1}] and not os.listdir(tmp_path)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(ranks=[0, 1, 2], model_parallel=2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_nccl_without_a_card_raises():
    with pytest.raises(RuntimeError, match="nccl"):
        multihost.initialize("127.0.0.1:1", num_processes=2, process_id=0, backend="nccl")
    assert not multihost.group_ready()


def _check_shardings(jax_shapes, port: torch.nn.Module, n: int) -> int:
    """``param_shardings(port)`` against JAX's rule on ``jax_shapes`` (a
    tree of shapes with the port's names) over ``n`` data ranks; returns
    how many leaves the rule splits."""
    from flax import traverse_util
    from jax.sharding import Mesh as JMesh

    from sam3_lora_tpu_torch.utils.checkpoint import jax_axes

    jmesh = JMesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("data", "model"))
    shapes = {".".join(k): v.shape for k, v in traverse_util.flatten_dict(jax_shapes).items()}
    ref = {".".join(k): tuple(v.spec) for k, v in traverse_util.flatten_dict(
        jax_param_shardings(jax_shapes, jmesh, shard_base=True)).items()}
    got = {}
    for name, placement in param_shardings(port, make_mesh(ranks=range(n)), shard_base=True).items():
        kernel = name[:-len("weight")] + "kernel"
        if not name.endswith("weight_scale"):
            got[kernel if name.endswith(".weight") and kernel in ref else name] = placement
    assert sorted(got) == sorted(k for k in ref if not k.endswith("kernel_scale"))
    split = 0
    for name, placement in got.items():
        module = port.get_submodule(name.rsplit(".", 1)[0]) if "." in name else port
        leaf = "weight" if name.endswith(".kernel") else name.rsplit(".", 1)[-1]
        axes = jax_axes(module, leaf, len(shapes[name]))
        assert [getattr(module, leaf).shape[a] for a in axes] == list(shapes[name]), name
        want = [None] * len(axes)
        if any(ref[name]):
            split += 1
            want[axes[next(i for i, a in enumerate(ref[name]) if a)]] = "data"
        assert placement.spec == (tuple(want) if any(want) else ()), name
    return split


@pytest.mark.parametrize("n", [2, 4])
def test_param_shardings_follow_jax_rule_on_the_tiny_tree(n):
    """The whole tiny tree (unscanned, the bench settings; its JAX shapes
    stored with ``torch_ref_eval_bench.npz``): the token embedding splits."""
    from test_torch_reference import BENCH, LORA_BENCH

    ref = _load("eval_bench")
    tree = {}
    for name, shape in json.loads(str(ref["params"])):
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(shape), np.float32)
    port = build_sam3_image_model(tiny_model_config(**BENCH), lora=LORA_BENCH, device="meta")
    assert _check_shardings(tree, port, n) >= 1


@pytest.mark.parametrize("n,want", [(2, 11), (3, 4)])
def test_param_shardings_follow_jax_rule_on_wide_layers(n, want):
    """A 256-wide ViT (patch-embed conv, qkv, the square proj where JAX's
    tie takes the input axis, the MLP, adapters) and attention in-projection,
    their JAX trees from ``jax.eval_shape``. Over 3 ranks only the 768-wide
    qkv and in-projection divide, and the patch embed's 3 input channels
    (its smallest axis, torch axis 1)."""
    import jax.numpy as jnp

    from sam3_lora_tpu.models.layers import MultiHeadAttention as JMHA
    from sam3_lora_tpu.models.layers import Spec as JSpec
    from sam3_lora_tpu.models.vit import ViT as JViT
    from sam3_lora_tpu_torch.models.layers import MultiHeadAttention, Spec

    kw = dict(vit_dim=256, vit_heads=4, vit_depth=2, vit_global_blocks=(1,), vit_scan_blocks=False)
    lora = dict(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "out_proj"))
    jspec = JSpec(model=jax_tiny_config(**kw), lora=JLoRAConfig(**lora))
    r = jspec.model.img_size
    vit = jax.eval_shape(lambda: JViT(jspec).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, r, r))))
    x = jnp.zeros((1, 5, 256))
    mha = jax.eval_shape(lambda: JMHA(256, 4, jspec).init(jax.random.PRNGKey(0), x, x, x))
    port = build_sam3_image_model(tiny_model_config(**kw), lora=LoRAConfig(**lora), device="meta")
    split = _check_shardings(vit["params"], port.backbone.vision_backbone.trunk, n)
    port_mha = MultiHeadAttention(256, 4, Spec(tiny_model_config(**kw), LoRAConfig(**lora)))
    split += _check_shardings(mha["params"], port_mha, n)
    assert split == want  # 2: patch embed, qkv, proj, fc1, fc2 of 2 blocks, in_proj, out_proj


@pytest.fixture(scope="module")
def ref_step():
    """The stored JAX training step and the port's tiny model with its weights."""
    ref = _load("train")
    cfg = tiny_model_config()
    specs = [(tuple(n.split(".")), tuple(s)) for n, s in json.loads(str(ref["params"]))]
    model = build_sam3_image_model(cfg, lora=LORA)
    load_jax_params(model, fill_params(specs))
    model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0  # as the reference's
    model.train()
    return ref, cfg, model


def _shard_grads(model, cfg, batch, group: bool):
    """Each shard's adapter gradients (JAX names and layout) and core loss.
    The collective's stand-in: with ``group``, the sum of both shards'
    counts and a group of 2; without, each shard's own counts."""
    params = trainable_parameters(model)
    shards = [shard_batch(batch, make_mesh(ranks=[0, 1]), rank=r) for r in (0, 1)]
    assert [s.token_ids.shape[0] for s in shards] == [2, 1]  # uneven rows
    outs = [model(s) for s in shards]
    local = []
    orig = port_losses._group_sum
    try:
        port_losses._group_sum = lambda v: (local.append(v.clone()), (v, 1))[1]
        for s, o in zip(shards, outs):
            port_losses.compute_losses(o, s.targets)
        results = []
        for s, o in zip(shards, outs):
            port_losses._group_sum = (lambda v: (local[0] + local[1], 2)) if group else (
                lambda v: (v, 1))
            model.zero_grad(set_to_none=True)
            loss = port_losses.compute_losses(o, s.targets)["core_loss"]
            loss.backward()
            results.append(([p.grad.clone() for _, p in params], loss.item()))
    finally:
        port_losses._group_sum = orig
    out = []
    with torch.no_grad():  # the gradients under the JAX names and layout
        saved = [p.detach().clone() for _, p in params]
        for grads, loss in results:
            for (_, p), g in zip(params, grads):
                p.copy_(g)
            out.append((stack_scanned(lora_state(model), cfg), loss))
        for (_, p), v in zip(params, saved):
            p.copy_(v)
    return out


def _mean_grad_errors(results, ref):
    errs = {}
    for k in (k[5:] for k in ref if k.startswith("grad/")):
        mean = (results[0][0][k] + results[1][0][k]) / 2
        r = ref[f"grad/{k}"]
        errs[k] = float(np.abs(mean - r).max() / np.abs(r).max())
    return errs


def test_sharded_gradient_with_group_counts_equals_jax_whole_batch(ref_step):
    ref, cfg, model = ref_step
    results = _shard_grads(model, cfg, _batch(ref), group=True)
    errs = _mean_grad_errors(results, ref)
    assert errs and max(errs.values()) <= GRAD_TOL, max(errs.items(), key=lambda kv: kv[1])
    # the logged loss, the ranks' mean, is the whole batch's
    mean_loss = (results[0][1] + results[1][1]) / 2
    np.testing.assert_allclose(mean_loss, float(ref["loss/core_loss"]), rtol=1e-4)


def test_sharded_gradient_with_own_counts_misses_jax_whole_batch(ref_step):
    ref, cfg, model = ref_step
    results = _shard_grads(model, cfg, _batch(ref), group=False)
    errs = _mean_grad_errors(results, ref)
    assert max(errs.values()) > 10 * GRAD_TOL


def test_shard_batch_takes_rows_with_their_images(ref_step):
    ref, _, _ = ref_step
    batch = _batch(ref)
    mesh = make_mesh(ranks=[0, 1])
    a, b = (shard_batch(batch, mesh, rank=r) for r in (0, 1))
    assert torch.equal(a.images, batch.images[:1]) and torch.equal(b.images, batch.images[1:])
    assert a.img_ids.tolist() == [0, 0] and b.img_ids.tolist() == [0]
    assert torch.equal(a.token_ids, batch.token_ids[[0, 2]])
    assert torch.equal(b.targets.boxes, batch.targets.boxes[[1]])
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(batch, make_mesh(ranks=[0, 1, 2]), rank=0)


# --------------------------------------------------------------------------
# two real processes (slow by design)
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2", **extra)
    return env


def _run_all(procs, timeout=300):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return outs


def test_two_process_fit_matches_one_process_whole_batch(tmp_path):
    import torch_dist_worker as worker

    worker.make_data(str(tmp_path))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"), str(tmp_path)],
        env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                 LOCAL_RANK=str(r)),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = _run_all(procs)
    for rank, out in enumerate(outs):
        assert f"WORKER_OK rank={rank}" in out, out
    adapters = [dict(np.load(tmp_path / f"adapters_rank{r}.npz")) for r in range(2)]
    for k in adapters[0]:
        np.testing.assert_array_equal(adapters[0][k], adapters[1][k], err_msg=k)
    # only rank 0 wrote into the output directory
    written = sorted(os.listdir(tmp_path / "out"))
    assert {"last_lora.npz", "train_state.npz", "train_stats.json", "val_stats.json"} <= set(written)
    with open(tmp_path / "out" / "train_stats.json") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == worker.STEPS and all(np.isfinite(r["loss"]) for r in records)
    # one process at the whole batch, the same global batches
    whole = worker.fit_whole_batch(str(tmp_path / "whole"))
    lr = worker.TCFG.learning_rate
    for k, v in whole.items():
        diff = np.abs(adapters[0][k] - v)
        assert diff.max() <= 0.5 * lr, (k, diff.max())
        assert np.mean(diff <= 1e-2 * lr) >= 0.99, k
    losses = [json.loads(line)["loss"] for line in open(tmp_path / "whole" / "train_stats.json")]
    np.testing.assert_allclose([r["loss"] for r in records], losses, rtol=1e-4)
    # the frame-parallel detector across both ranks: every frame on every rank
    for r in range(2):
        got = np.load(tmp_path / f"frames_rank{r}.npy")
        np.testing.assert_allclose(got, worker.frames_reference(), rtol=1e-6)


def test_train_cli_under_torch_distributed_run(tmp_path):
    import torch_dist_worker as worker

    cfg = worker.write_cli_config(str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "2",
         "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
         "-m", "sam3_lora_tpu_torch.cli.train", "--config", cfg, "--device", "cpu"],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _run_all([proc])
    out_dir = tmp_path / "out"
    assert {"last_lora.npz", "result.json", "train.log", "train_stats.json"} <= set(os.listdir(out_dir))
    result = json.load(open(out_dir / "result.json"))
    assert result["steps"] == 2 and np.isfinite(result["history"]["train_loss"]).all()
