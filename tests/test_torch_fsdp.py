"""The sharded frozen base (``parallel.shard_params_``, ``parallel/fsdp.py``):
each rank keeps only its slice of every base weight that JAX's
``param_shardings(..., shard_base=True)`` splits, and each module gathers the
whole weight where it uses it.

The multi-process checks run in a 2-process gloo group on the CPU
(``tests/torch_fsdp_worker.py``, one module fixture a group of parts), each
against the same work unsharded in the same processes:

* every module type that holds a sharded leaf at the full config, built at a
  size where the rule splits it: output and gradients bit for bit, the
  gathered leaves equal to the unsharded ones, each rank's slice, its
  parameter bytes as the placement predicts;
* no gathered weight alive between the forward and the backward (autograd
  keeps alive what it saves), and a control in which one is;
* ``prequantize_model`` of a sharded model equal to JAX's
  ``prequantize_base``, the writers on a sharded model;
* the tiny config's training step in the int8 tier at accumulation 2: bit
  for bit the unsharded step in the same two processes, sharded by JAX's
  rule (only the text embedding splits at the tiny widths) and with every
  base leaf split; and against JAX's own step with the base sharded by the
  rule on the (4, 2) mesh of 8 CPU devices
  (``tests/data/torch_ref_train_int8_fsdp.npz``).

JAX's stored step comes with each microbatch replicated on the mesh and with
it split over the data axis (``tests/test_quant.py``'s placement). In the
int8 tier the two differ: JAX's jitted program for the split batch moves some
activations by an int8 step (6.2e-2 of the largest gradient entry, 3.0e-4 of
the loss; op by op still 3.8e-3; with the fp32 base 7.3e-6, and the base's
placement alone changes no bit). So the port, whose two ranks compute each
prompt row as one process does, is held to GRAD_TOL of the replicated one,
and to no farther from the split one than JAX's replicated run is.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

from sam3_lora_tpu_torch.config import LoRAConfig, ModelConfig
from sam3_lora_tpu_torch.models import build_sam3_image_model
from sam3_lora_tpu_torch.models.layers import Spec
from sam3_lora_tpu_torch.models.text_encoder import TextTransformer
from sam3_lora_tpu_torch.parallel import fsdp
from sam3_lora_tpu_torch.parallel.mesh import (
    DATA_AXIS, Sharding, data_groups, make_mesh, param_shardings, shard_params_)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_fsdp_worker.py")
DATA = os.path.join(ROOT, "tests", "data")
GRAD_TOL = 2e-3  # of each gradient's largest entry
LOSS_RTOL = 1e-4
# the leaves each module case splits, by the rule, and the axis
CASE_DIMS = {
    "linear_dim0": {"weight": 0},
    "linear_dim1": {"weight": 1},
    "linear_int8_dim1": {"weight": 1},
    "linear_int8_bwd_dim0": {"weight": 0},
    "linear_int8_per_call": {"weight": 1},
    "linear_int8_fused": {"weight": 0},
    "mha": {"in_proj_weight": 0, "out_proj.weight": 1},
    "conv_dim0": {"weight": 0},
    "conv_dim1": {"weight": 1},
    "conv_transpose": {"weight": 0},
    "vit": {"pos_embed": 2, "patch_embed.proj.weight": 0, "blocks.0.mlp.fc1.weight": 0,
            "blocks.0.mlp.fc2.weight": 1, "blocks.1.mlp.fc1.weight": 0,
            "blocks.1.mlp.fc2.weight": 1},
    "text": {"token_embedding.weight": 0, "text_projection": 0,
             "transformer.resblocks.0.attn.in_proj_weight": 0,
             "transformer.resblocks.0.attn.out_proj.weight": 1,
             "transformer.resblocks.0.mlp.c_fc.weight": 0,
             "transformer.resblocks.0.mlp.c_proj.weight": 1},
}
# the gathers of one forward and one backward: one a use, and in the
# backward one a saved use (MHA's in_proj three, one a q/k/v view), the
# ViT's windowed block replaying its two under remat
CASE_GATHERS = {"mha": (2, 4), "vit": (6, 5), "text": (5, 1)}
STEPS = ("jax_rule", "every_leaf")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(base, *parts) -> list:
    """The worker's ``parts`` in two gloo ranks; each rank's results."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(base), *parts],
        env={**env, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2", "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": port, "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r)},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK rank={rank}" in out, f"rank {rank}:\n{out}"
    return [{part: torch.load(os.path.join(base, f"{part}_rank{r}.pt")) for part in parts}
            for r in range(2)]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return [r["cases"] for r in _spawn(tmp_path_factory.mktemp("cases"), "cases")]


@pytest.fixture(scope="module")
def writers(tmp_path_factory):
    base = tmp_path_factory.mktemp("writers")
    return base, _spawn(base, "writers", "quant")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("steps"), "plain", "jax_rule")


@pytest.fixture(scope="module")
def every_leaf_step(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("every"), "every_leaf")


@pytest.fixture
def step_runs(steps, every_leaf_step):
    """Each rank's runs of the step: plain, jax_rule and every_leaf."""
    return [{**a, **b} for a, b in zip(steps, every_leaf_step)]


@pytest.fixture(scope="module")
def jax_ref():
    with np.load(os.path.join(DATA, "torch_ref_train_int8_fsdp.npz")) as data:
        return {k: data[k] for k in data.files}


# --------------------------------------------------------------------------
# without processes
# --------------------------------------------------------------------------

def test_data_groups_of_a_4x2_mesh():
    mesh = make_mesh(ranks=range(8), model_parallel=2)
    assert mesh.shape == {"data": 4, "model": 2}
    assert data_groups(mesh) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    for rank in range(8):
        d, m = mesh.coords(rank)
        assert data_groups(mesh)[m][d] == rank


def test_every_leaf_the_rule_splits_at_the_full_config_is_gathered_at_use():
    """The census of JAX's rule on a ``meta`` model of the full config at 2
    data ranks: 365 leaves, 3.125 of 3.137 GiB in fp32, each a leaf its
    module gathers at use (so ``shard_params_`` takes the whole placement)."""
    model = build_sam3_image_model(ModelConfig(), lora=LoRAConfig(), device="meta")
    shardings = param_shardings(model, make_mesh(ranks=range(2)), shard_base=True)
    census, split_bytes = {}, 0
    for name, p in model.named_parameters():
        if DATA_AXIS not in shardings[name].spec:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        assert leaf in getattr(owner, "SHARDED_AT_USE", ()), name
        key = (type(owner).__name__, leaf, shardings[name].spec.index(DATA_AXIS))
        census[key] = census.get(key, 0) + 1
        split_bytes += p.numel() * p.element_size()
    assert census == {
        ("LoRALinear", "weight", 0): 104, ("LoRALinear", "weight", 1): 181,
        ("MultiHeadAttention", "in_proj_weight", 0): 61,
        ("Conv2d", "weight", 1): 12, ("Conv2d", "weight", 0): 1,
        ("ConvTranspose2x2", "weight", 0): 3, ("ViT", "pos_embed", 2): 1,
        ("TextTransformer", "text_projection", 0): 1, ("Embedding", "weight", 0): 1}
    assert split_bytes == 3355760640  # 3.125 GiB


def test_shard_params_refuses_before_it_changes_anything():
    spec = Spec(ModelConfig(text_width=64, text_layers=1, text_heads=2, text_vocab_size=64,
                            text_proj_dim=64))
    model = TextTransformer(spec)
    mesh = make_mesh(ranks=range(2))
    before = list(model.parameters())
    # positional_embedding is read by slicing, not gathered at use
    with pytest.raises(ValueError, match="does not gather 'positional_embedding'"):
        shard_params_(model, {"text_projection": Sharding(mesh, (DATA_AXIS, None)),
                              "positional_embedding": Sharding(mesh, (DATA_AXIS, None))})
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        shard_params_(model, {"token_embedding.weight": Sharding(make_mesh(ranks=range(3)),
                                                                 (None, DATA_AXIS))})
    with pytest.raises(RuntimeError, match="needs a process group"):
        shard_params_(model, {"text_projection": Sharding(mesh, (DATA_AXIS, None))})
    assert all(a is b for a, b in zip(model.parameters(), before))
    assert fsdp.shard_of(model, "text_projection") is None


def test_a_sharded_leaf_takes_no_gradient():
    layer = nn.Linear(4, 4)
    fsdp.mark(layer, "weight", fsdp.Shard(0, 2, 0, None))
    with pytest.raises(RuntimeError, match="takes no gradient"):
        fsdp.full(layer, "weight")
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        fsdp.local(fsdp.Shard(1, 3, 0, None), torch.zeros(2, 4))
    assert torch.equal(fsdp.local(fsdp.Shard(1, 2, 1, None), torch.arange(8).view(2, 4)),
                       torch.tensor([[2, 3], [6, 7]]))


# --------------------------------------------------------------------------
# two processes
# --------------------------------------------------------------------------

def test_the_cases_cover_the_census(cases):
    assert all(set(r) == set(CASE_DIMS) for r in cases)


@pytest.mark.parametrize("case", sorted(CASE_DIMS))
def test_sharded_module_bit_for_bit(cases, case):
    for rank, res in enumerate(cases):
        r = res[case]
        assert r["dims"] == CASE_DIMS[case], (rank, r["dims"])
        assert r["out_equal"] and r["grads_equal"] and r["n_grads"] > 0, (rank, r)
        assert all(r["full_equal"].values()) and set(r["full_equal"]) == set(CASE_DIMS[case])
        assert all(r["slice_equal"].values()), (rank, r["slice_equal"])
        assert r["bytes"] == r["predicted_bytes"], rank
        fwd, bwd = CASE_GATHERS.get(case, (1, 1))
        assert r["gathers"] == {"forward": fwd, "backward": bwd}, (rank, r["gathers"])


def test_the_writer_ranks_report_every_part(writers):
    assert [sorted(r) for r in writers[1]] == [["quant", "writers"]] * 2


def test_prequantize_of_a_sharded_model_equals_jax(writers):
    """Every quantized layer of the tiny int8 model, its weight split (63 of
    63, some on the input features, the axis the scale reduces over), gives
    JAX's int8 weight and scale."""
    for r in writers[1]:
        assert r["quant"] == {"quantized": 63, "split": 63, "differ": []}


def test_writers_on_a_sharded_model(writers):
    """``save_base_checkpoint`` writes the whole base from every rank, equal
    to the unsharded model's file; ``merge_lora_into_base`` gives each rank
    its slice of the unsharded merge; ``save_state`` (adapters and
    optimizer, replicated) writes the same file as unsharded."""
    base, results = writers
    for rank, r in enumerate(results):
        w = r["writers"]
        assert w["sharded"] > 100 and w["merged_equal"] and all(w["merged_equal"].values())
        with np.load(base / f"base_rank{rank}.npz") as got, \
                np.load(base / f"base_ref_rank{rank}.npz") as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    plain, sharded = results[0]["writers"]["states"]
    with np.load(plain) as want, np.load(sharded) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _ranks_agree(runs, tags):
    """The group's mean losses and gradients are the same on both ranks."""
    for tag in tags:
        a, b = runs[0][tag], runs[1][tag]
        assert all(torch.equal(a["losses"][k], b["losses"][k]) for k in a["losses"]), tag
        assert all(torch.equal(a["grads"][k], b["grads"][k]) for k in a["grads"]), tag


def test_the_step_ranks_agree(steps):
    _ranks_agree(steps, ("plain", "jax_rule"))


def test_the_every_leaf_ranks_agree(every_leaf_step):
    _ranks_agree(every_leaf_step, ("every_leaf",))


def _bit_for_bit_unsharded(runs, tag):
    """The reduced losses and adapter gradients of the sharded step equal the
    unsharded step's in the same two processes; each rank holds the bytes
    the placement predicts, fewer than unsharded."""
    for rank in range(2):
        plain, r = runs[rank]["plain"], runs[rank][tag]
        assert r["gathers"]["forward"] > 0
        for k, v in plain["losses"].items():
            assert torch.equal(r["losses"][k], v), (rank, k)
        assert sorted(r["grads"]) == sorted(plain["grads"])
        for k, v in plain["grads"].items():
            assert torch.equal(r["grads"][k], v), (rank, k)
        assert r["bytes"] == r["predicted_bytes"] < plain["bytes"] == plain["predicted_bytes"]


def test_jax_rule_step_bit_for_bit_unsharded(steps):
    _bit_for_bit_unsharded(steps, "jax_rule")
    # at the tiny widths the rule splits the text embedding alone
    assert steps[0]["jax_rule"]["dims"] == {
        "backbone.language_backbone.encoder.token_embedding.weight": 0}


def test_every_leaf_step_bit_for_bit_unsharded(step_runs):
    _bit_for_bit_unsharded(step_runs, "every_leaf")
    r = step_runs[0]["every_leaf"]
    assert len(r["dims"]) == 111 and r["gathers"]["backward"] > 0


@pytest.mark.parametrize("tag", ("plain",) + STEPS)
def test_step_matches_jax_sharded_step(step_runs, jax_ref, tag):
    """The group's mean loss terms within LOSS_RTOL, and the mean gradients
    within GRAD_TOL of each gradient's largest entry, of JAX's step with the
    base sharded by the rule (each microbatch replicated on the mesh); and
    no farther from JAX's step with the batch split over the data axis than
    JAX's replicated run is, plus GRAD_TOL."""
    r = step_runs[0][tag]
    terms = {k[5:] for k in jax_ref if k.startswith("loss/")}
    assert sorted(r["losses"]) == sorted(terms)
    for k in terms:
        np.testing.assert_allclose(float(r["losses"][k]), jax_ref[f"replicated/loss/{k}"],
                                   rtol=LOSS_RTOL, atol=1e-5, err_msg=k)
    names = {k[5:] for k in jax_ref if k.startswith("grad/")}
    assert sorted(r["grads"]) == sorted(names) and names
    for k in names:
        got, rep, split = (r["grads"][k].numpy(), jax_ref[f"replicated/grad/{k}"],
                           jax_ref[f"grad/{k}"])
        scale = float(np.abs(rep).max())
        assert scale > 0, k
        np.testing.assert_allclose(got, rep, rtol=0, atol=GRAD_TOL * scale, err_msg=k)
        assert np.abs(got - split).max() <= np.abs(rep - split).max() + GRAD_TOL * scale, k


def test_autograd_holds_no_gathered_weight(cases, step_runs):
    """Between the forward and the backward no gathered tensor is alive, in
    every module case and in every microbatch of the sharded steps; the
    control (the forward without the model's hooks) holds one."""
    for rank in range(2):
        for case, r in cases[rank].items():
            assert r["live_after_forward"] == 0, (rank, case)
        assert cases[rank]["linear_dim0"]["live_unpacked"] == 1
        for tag in STEPS:
            assert step_runs[rank][tag]["live_after_forward"] == [0, 0], (rank, tag)
