"""The port's remat policies (``vit_remat_policy``, ``enc_remat``,
``enc_remat_ffn``, ``dec_remat``) and named saves (``ops/remat.py``) on the
CPU:

* every combination gives the same loss and adapter gradients as the
  ``windows_only`` run, with every dropout rate above zero (the replays draw
  the first pass's masks): loss within 1e-6, gradients within 1e-5, as
  ``tests/test_remat_policies.py`` holds the JAX policies;
* spies on the attention entries' computations show that a region which
  keeps the attention output (``wo_block_mid``/``block_mid`` in the ViT,
  ``enc_remat`` in the encoder) replays no attention forward, and that
  ``full``/``windows_only`` do;
* no replay runs fc2's frozen product (nor the encoder's linear2 under
  ``enc_remat``), under every policy with every dropout above 0, in the
  float tier and the int8 tier's three Functions (prequantized, quantized
  per call, fused with the adapters);
* at ``bench.py``'s settings and at the ``windows_only`` default of
  chip_smoke's train-int8, a training step computes each kernel as often as
  ``chip_smoke.bench_step_launches`` / ``train_step_launches`` expect on the
  card;
* an unknown policy is refused in training.

The CPU takes the card's attention routes here (``window_attention.
_FORCE_INTERPRET``), through the entries' plain versions.
"""

import collections
import contextlib

import pytest
import torch

import chip_smoke
from sam3_lora_tpu_torch.config import LoRAConfig, bench_lora_config, tiny_model_config
from sam3_lora_tpu_torch.models import build_sam3_image_model, init_model
from sam3_lora_tpu_torch.models.builder import dummy_batch
from sam3_lora_tpu_torch.models.lora import trainable_parameters
from sam3_lora_tpu_torch.ops import attention_kernel as ak
from sam3_lora_tpu_torch.ops import gemm_int8, quant, remat
from sam3_lora_tpu_torch.ops import window_attention as wa
from sam3_lora_tpu_torch.train.losses import compute_losses

LORA = LoRAConfig(rank=4, alpha=8.0, dropout=0.1,
                  target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))
DROPOUT = dict(vit_drop_path_rate=0.2, enc_dropout=0.1, dec_dropout=0.1)
POLICIES = ("full", "block_mid", "windows_only", "wo_block_mid")
ENCODER = {"enc_remat": dict(enc_remat=True, enc_remat_ffn=False),
           "enc_remat_ffn": dict(enc_remat=False, enc_remat_ffn=True),
           "none": dict(enc_remat=False, enc_remat_ffn=False)}


@pytest.fixture
def card_routes(monkeypatch):
    monkeypatch.setattr(wa, "_FORCE_INTERPRET", True)


@pytest.fixture
def spies(monkeypatch):
    """Counts of each attention entry's forward and backward computations
    (not of replays that take a kept result back) and of K4's."""
    calls = collections.Counter()
    stack = []

    def on_entry(fn):
        def wrapped(entry, *a, **k):
            stack.append(entry.__name__)
            try:
                return fn(entry, *a, **k)
            finally:
                stack.pop()
        return wrapped

    def counted(fn, suffix):
        def wrapped(*a, **k):
            calls[stack[-1] + suffix] += 1
            return fn(*a, **k)
        return wrapped

    def counted_gemm(*a, **k):
        calls["int8_gemm_wres"] += 1
        return gemm_int8.int8_gemm_wres_plain(*a, **k)

    monkeypatch.setattr(ak, "_forward", on_entry(ak._forward))
    monkeypatch.setattr(ak, "_backward", on_entry(ak._backward))
    monkeypatch.setattr(ak, "attention_plain", counted(ak.attention_plain, ""))
    monkeypatch.setattr(ak, "attention_bwd_plain", counted(ak.attention_bwd_plain, "_bwd"))
    monkeypatch.setattr(gemm_int8, "int8_gemm_wres", counted_gemm)
    return calls


def _step(cfg, lora, seed=0, on_model=None, prequant=True):
    """(loss, adapter gradients) of one training step with live adapters and
    seeded dropout; ``on_model`` sees the model before the step. An int8
    config's base is prequantized unless ``prequant`` is False (the weights
    stay float and are quantized on every call)."""
    model = build_sam3_image_model(cfg, lora=lora, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    if cfg.base_quant != "none" and prequant:
        quant.prequantize_model(model, cfg.base_quant_min_dim)
    if on_model is not None:
        on_model(model)
    named = trainable_parameters(model)
    model.train()
    model.seed_dropout(seed)
    batch = dummy_batch(cfg, 2, with_targets=True)
    loss = compute_losses(model(batch), batch.targets)["core_loss"]
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in named}


@pytest.fixture(scope="module")
def windows_only_step():
    return _step(tiny_model_config(**DROPOUT), LORA)


COMBINATIONS = [(p, e, d) for p in POLICIES for e in ENCODER for d in (False, True)
                if (p, e, d) != ("windows_only", "enc_remat", False)]  # the reference run


@pytest.mark.parametrize("policy,encoder,dec_remat", COMBINATIONS)
def test_policies_match_windows_only(windows_only_step, policy, encoder, dec_remat):
    cfg = tiny_model_config(vit_remat_policy=policy, dec_remat=dec_remat, **ENCODER[encoder],
                            **DROPOUT)
    ref_loss, ref = windows_only_step
    loss, grads = _step(cfg, LORA)
    assert loss == pytest.approx(ref_loss, abs=1e-6)
    assert sorted(grads) == sorted(ref)
    for n in ref:
        torch.testing.assert_close(grads[n], ref[n], rtol=0, atol=1e-5, msg=n)


INT8 = dict(base_quant="int8", base_quant_min_dim=16)  # the gate covers the tiny ViT


@pytest.fixture(scope="module")
def windows_only_int8_step():
    return _step(tiny_model_config(**INT8, **DROPOUT), LORA)


@pytest.mark.parametrize("policy", ["block_mid", "wo_block_mid"])
def test_split_policies_match_windows_only_int8(windows_only_int8_step, policy):
    """The int8 tier, whose frozen product saves nothing for the backward,
    gives the same numbers under the split policies."""
    ref_loss, ref = windows_only_int8_step
    loss, grads = _step(tiny_model_config(vit_remat_policy=policy, **INT8, **DROPOUT), LORA)
    assert loss == pytest.approx(ref_loss, abs=1e-6)
    assert sorted(grads) == sorted(ref)
    for n in ref:
        torch.testing.assert_close(grads[n], ref[n], rtol=0, atol=1e-5, msg=n)


# rank 8, no LoRA dropout: the adapted int8 layers take K5 (GEMM_LORA_FUSED)
FUSED_LORA = LoRAConfig(rank=8, alpha=16.0, dropout=0.0, target_modules=LORA.target_modules)
VIT_LAYERS = (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))


@pytest.mark.parametrize("tier", ["bf16", "int8", "int8-dynamic", "int8-fused"])
@pytest.mark.parametrize("policy", ["block_mid", "wo_block_mid", "windows_only", "full"])
def test_mlp_replay_stops_before_fc2_frozen_product(monkeypatch, policy, tier):
    """No replay computes fc2's frozen product, which no gradient reads, as
    XLA drops it; nor the encoder's linear2 under ``enc_remat``. With every
    dropout above 0 (drop-path 0.2 after fc2, encoder dropout 0.1 after
    linear2) a rematted ViT block computes qkv's and fc1's frozen products
    twice (forward and replay), proj's twice where the block replays whole
    (``full``, ``windows_only``) and once where its MLP is a region of its
    own (``block_mid``, ``wo_block_mid``), fc2's once; an encoder layer
    linear1's twice and linear2's once. Tiers: the float F.linear, the
    prequantized int8 Function (K4), the int8 Function that quantizes per
    call (``_Int8Matmul``, K4) and the fused adapter Function (K5, rank 8,
    LoRA dropout 0), whose products the spies count where they run: F.linear
    by the weight it read, K4 and K5 by the LoRALinear that called them."""
    from sam3_lora_tpu_torch.models import layers

    cfg = tiny_model_config(vit_remat_policy=policy, **DROPOUT,
                            **({} if tier == "bf16" else INT8))
    lora = FUSED_LORA if tier == "int8-fused" else LORA
    monkeypatch.setattr(gemm_int8, "GEMM_LORA_FUSED", tier == "int8-fused")
    calls, names = collections.Counter(), {}

    def on_model(model):
        for name, m in model.named_modules():
            if ".trunk.blocks." in name and name.endswith(("qkv", "proj", "fc1", "fc2")):
                key = name.split(".trunk.blocks.")[1]
            elif ".encoder.layers." in name and name.endswith(("linear1", "linear2")):
                key = "enc." + name.split(".encoder.layers.")[1]
            else:
                continue
            names[id(m.weight if tier == "bf16" else m)] = key

    if tier == "bf16":
        linear = torch.nn.functional.linear

        def spied_linear(x, w, *a, **k):
            out = linear(x, w, *a, **k)
            if id(w) in names:
                calls[names[id(w)]] += 1
            return out
        monkeypatch.setattr(layers.F, "linear", spied_linear)
    else:
        stack, forward = [], layers.LoRALinear.forward

        def traced(self, x):
            stack.append(names.get(id(self)))
            try:
                return forward(self, x)
            finally:
                stack.pop()

        def counted(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                if stack and stack[-1] is not None:
                    calls[stack[-1]] += 1
                return out
            return wrapped
        monkeypatch.setattr(layers.LoRALinear, "forward", traced)
        for fn in ("int8_gemm_wres", "int8_lora_gemm_wres"):
            monkeypatch.setattr(gemm_int8, fn, counted(getattr(gemm_int8, fn)))
    _step(cfg, lora, on_model=on_model, prequant=tier != "int8-dynamic")
    assert len(names) == 4 * cfg.vit_depth + 2 * cfg.enc_layers
    for i in range(cfg.vit_depth):
        windowed = i not in cfg.vit_global_blocks
        replayed = policy in ("block_mid", "full") or windowed
        whole = replayed and policy in ("windows_only", "full")
        got = {layer: calls[f"{i}.{path}"] for layer, path in VIT_LAYERS}
        want = {"qkv": 1 + replayed, "proj": 1 + whole, "fc1": 1 + replayed, "fc2": 1}
        assert got == want, (i, got)
    for i in range(cfg.enc_layers):
        got = (calls[f"enc.{i}.linear1"], calls[f"enc.{i}.linear2"])
        assert got == (2, 1), (i, got)


@pytest.mark.parametrize("tier", ["bf16", "int8-fused"])
@pytest.mark.parametrize("policy", ["windows_only", "full"])
def test_held_masks_change_no_number(monkeypatch, policy, tier):
    """Holding the drop-path and dropout masks past the regions (and saving
    the fused Function's operands before its product) changes no number:
    the step's loss and every adapter gradient equal, bit for bit, those of
    a run whose masks are saved through the regions and redrawn by their
    replays."""
    cfg = tiny_model_config(vit_remat_policy=policy, **DROPOUT,
                            **({} if tier == "bf16" else INT8))
    lora = FUSED_LORA if tier == "int8-fused" else LORA
    monkeypatch.setattr(gemm_int8, "GEMM_LORA_FUSED", tier == "int8-fused")
    loss, grads = _step(cfg, lora)
    monkeypatch.setattr(remat, "held", contextlib.nullcontext)
    ref_loss, ref = _step(cfg, lora)
    assert loss == ref_loss
    assert sorted(grads) == sorted(ref)
    for n in ref:
        assert torch.equal(grads[n], ref[n]), n


def test_train_int8_launch_counts_match_chip_smoke(card_routes, spies):
    """A CPU rehearsal of chip_smoke's train-int8 counts: the windows_only
    policy, where a windowed block replays whole but for fc2's frozen
    product, whose drop-path mask is held past the region: 284 K4 launches
    a step at the full config."""
    cfg = tiny_model_config(
        d_model=16, enc_heads=2, dec_heads=2, base_quant="int8", base_quant_min_dim=32,
        flash_attention_min_seq=16, vit_drop_path_rate=0.2)
    _step(cfg, LORA)
    assert dict(spies) == chip_smoke.train_step_launches(cfg)
    full = chip_smoke.train_step_launches(chip_smoke.model_config(int8=True))
    assert full["int8_gemm_wres"] == 284


@pytest.mark.parametrize("policy,encoder,win,enc", [
    ("windows_only", "enc_remat", 2, 1),   # windowed blocks replay; the encoder keeps o
    ("full", "none", 2, 1),                # every block replays, globals included
    ("wo_block_mid", "enc_remat", 1, 1),   # no attention replays
    ("block_mid", "enc_remat_ffn", 1, 1),
])
def test_kept_attention_outputs_are_not_replayed(card_routes, spies, policy, encoder, win, enc):
    cfg = tiny_model_config(vit_remat_policy=policy, flash_attention_min_seq=16,
                            **ENCODER[encoder])
    _step(cfg, LORA)
    n_global = len(cfg.vit_global_blocks)
    n_win = cfg.vit_depth - n_global
    glob = 2 if policy == "full" else 1
    assert spies["window_attention_rope_packed"] == win * n_win
    assert spies["long_attention_rope_packed"] == glob * n_global
    assert spies["long_attention_packed"] == enc * cfg.enc_layers
    # one backward each: the kept outputs feed the backward kernels
    assert spies["window_attention_rope_packed_bwd"] == n_win
    assert spies["long_attention_packed_bwd"] == cfg.enc_layers


def test_bench_settings_launch_counts_match_chip_smoke(card_routes, spies):
    """A CPU rehearsal of chip_smoke's bench-train counts: bench.py's
    settings on a tiny config whose int8 gate covers the ViT and the text
    encoder alone, as the full config's does."""
    cfg = tiny_model_config(
        d_model=16, enc_heads=2, dec_heads=2, base_quant="int8", base_quant_min_dim=32,
        param_dtype="bfloat16", vit_remat_policy="wo_block_mid", enc_remat=False,
        enc_remat_ffn=True, dec_remat=False, flash_attention_min_seq=16)
    model = build_sam3_image_model(cfg, lora=bench_lora_config(), device="cpu")
    quantized = [n for n, m in model.named_modules() if getattr(m, "weight_scale", None) is not None]
    assert quantized and all(".trunk." in n or "language_backbone" in n for n in quantized)
    _step(cfg, bench_lora_config())
    want = chip_smoke.bench_step_launches(cfg)
    assert dict(spies) == want


def test_unknown_policy_rejected_in_training():
    cfg = tiny_model_config(vit_remat_policy="nonsense")
    model = build_sam3_image_model(cfg, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(dummy_batch(cfg, 1))  # eval mode runs no policy
    model.train()
    model.seed_dropout(0)
    with pytest.raises(ValueError, match="vit_remat_policy"):
        model(dummy_batch(cfg, 1, with_targets=True))
