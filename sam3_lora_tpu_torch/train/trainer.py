"""LoRA trainer (port of ``sam3_lora_tpu/train/trainer.py``): the train step
(forward with targets, losses, backward to the adapters only, global-norm
clip, AdamW on a per-step learning rate), gradient accumulation, the
JSON-lines stats, the NaN abort, adapter checkpoints in the JAX format and a
resumable train state.

The JAX step differentiates with respect to the adapter subtree; here every
base parameter has ``requires_grad=False`` (``models/lora.py::
trainable_parameters``), so autograd forms no base-weight gradient either.
The clip and the schedule follow optax's definitions exactly: the clip
scales by max/norm only when norm >= max (``torch.nn.utils.
clip_grad_norm_`` would use max/(norm + 1e-6)), and update ``i`` (from 0)
takes the schedule's value at ``i``, so under warmup the first update has
lr = 0. AdamW's decoupled decay is the same in torch and optax.

Data-parallel training runs one process per card under
``torch.distributed`` (``parallel/multihost.py``; ``cli/train.py`` under
``torch.distributed.run``). Each rank steps its own shard of the batch; the
losses take the group's denominators (``train/losses.py``), so the mean of
the ranks' adapter gradients, one all-reduce an update, is the gradient of
the whole batch's loss, as in JAX's global-view step. The adapters start
from rank 0's, every rank's dropout draws its own masks, the logged losses
and the validation loss are group means, and only rank 0 writes files.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import LoRAConfig, ModelConfig, TrainConfig
from ..models import Batch, build_sam3_image_model, init_model
from ..models.lora import save_lora_weights, trainable_parameters
from ..ops.quant import prequantize_model
from ..parallel import dist_utils, multihost
from ..utils.logging import MemMeter, TensorBoardLogger, trace_span
from .losses import LossConfig, compute_losses
from .prefetch import batch_to_device, map_tensors, prefetch_to_device

log = logging.getLogger("sam3_lora_tpu_torch")


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate of update ``step`` (0-based), as the JAX package's optax
    schedules give it: linear warmup from 0 then cosine decay to 1% of the
    peak, the reference's inverse square root, or a constant."""
    total = max(1, cfg.num_epochs * steps_per_epoch // max(1, cfg.gradient_accumulation_steps))
    warmup = min(cfg.warmup_steps, max(total - 1, 1))
    peak = cfg.learning_rate
    if cfg.lr_scheduler == "cosine":
        decay = total - warmup
        if decay <= 0:
            raise ValueError(f"cosine schedule needs more than {warmup} updates, got {total}")
        alpha = 0.01

        def cosine(step: int) -> float:
            if step < warmup:
                return peak * min(max(step, 0), warmup) / warmup if warmup > 0 else 0.0
            t = min(step - warmup, decay)
            return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

        return cosine
    if cfg.lr_scheduler == "inverse_sqrt":
        def inverse_sqrt(step: int) -> float:
            if step < warmup:
                return peak * step / max(warmup, 1)
            s = max(step, 1)
            return peak * (math.sqrt(warmup / s) if warmup > 0 else 1.0 / math.sqrt(s))

        return inverse_sqrt
    if cfg.lr_scheduler == "constant":
        return lambda step: peak
    raise ValueError(f"unknown lr_scheduler: {cfg.lr_scheduler}")


def make_optimizer(cfg: TrainConfig, params: List[torch.nn.Parameter], steps_per_epoch: int):
    """-> (AdamW over ``params``, the schedule). The learning rate is set
    from the schedule before every update (``apply_update``)."""
    opt = torch.optim.AdamW(
        params, lr=0.0, betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_epsilon,
        weight_decay=cfg.weight_decay,
    )
    return opt, make_lr_schedule(cfg, steps_per_epoch)


@torch.no_grad()
def clip_by_global_norm_(params: List[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: scale every gradient by max/norm when
    the global norm is at least ``max_norm``. Returns the norm, on the
    device, without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def apply_update(optimizer: torch.optim.Optimizer, params, lr: float,
                 max_grad_norm: Optional[float]):
    """Clip (unless ``max_grad_norm`` is None), step each param group at
    ``lr`` times its ``lr_scale`` (1 without one), clear the gradients."""
    if max_grad_norm is not None:
        clip_by_global_norm_(params, max_grad_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def split_microbatches(batch: Batch, accum: int) -> List[Batch]:
    """(B, ...) rows -> ``accum`` batches of B/accum rows; each carries the
    images its rows index (``img_ids`` renumbered from 0)."""
    if accum == 1:
        return [batch]
    b = batch.token_ids.shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} microbatches")
    m = b // accum
    out = []
    for i in range(accum):
        rows = slice(i * m, (i + 1) * m)

        def take(t, rows=rows):
            return t[rows]

        mb = Batch(
            images=batch.images[batch.img_ids[rows]],
            token_ids=batch.token_ids[rows],
            img_ids=torch.arange(m, device=batch.img_ids.device),
            geo=map_tensors(batch.geo, take),
            targets=map_tensors(batch.targets, take),
        )
        out.append(mb)
    return out


def train_step(model, batch: Batch, loss_cfg: LossConfig, accum: int = 1) -> Dict[str, torch.Tensor]:
    """Forward with targets, losses and backward over ``accum`` microbatches;
    the adapters' ``.grad`` hold the mean gradient. Returns the mean of each
    loss term, detached, on the device."""
    model.train()
    total: Dict[str, torch.Tensor] = {}
    for mb in split_microbatches(batch, accum):
        with trace_span("sam3.forward"):
            out = model(mb)
        with trace_span("sam3.loss"):
            losses = compute_losses(out, mb.targets, loss_cfg)
        with trace_span("sam3.backward"):
            (losses["core_loss"] / accum).backward()
        for k, v in losses.items():
            total[k] = total.get(k, 0.0) + v.detach() / accum
    return total


class Trainer:
    """End-to-end LoRA fine-tuning driver (CLI: ``sam3_lora_tpu_torch.cli.train``)."""

    def __init__(
        self,
        model_cfg: Optional[ModelConfig] = None,
        lora_cfg: Optional[LoRAConfig] = None,
        train_cfg: Optional[TrainConfig] = None,
        base_checkpoint: Optional[str] = None,
        loss_cfg: Optional[LossConfig] = None,
        device="cuda",
    ):
        self.mcfg = model_cfg or ModelConfig()
        self.lcfg = lora_cfg or LoRAConfig()
        self.tcfg = train_cfg or TrainConfig()
        self.loss_cfg = loss_cfg or LossConfig()
        self.device = torch.device(device)  # the card unless the caller asks for the CPU
        self.model = build_sam3_image_model(self.mcfg, lora=self.lcfg, device=self.device)
        self.base_checkpoint = base_checkpoint
        self.step = 0  # optimizer updates taken
        os.makedirs(self.tcfg.output_dir, exist_ok=True)

    def setup(self, steps_per_epoch: int) -> Dict[str, float]:
        init_model(self.model, torch.Generator(device=self.device).manual_seed(self.tcfg.seed))
        if self.base_checkpoint:
            from ..utils.checkpoint import load_base_checkpoint

            n = load_base_checkpoint(self.model, self.base_checkpoint, strict=False)
            log.info("loaded %d base tensors from %s", n, self.base_checkpoint)
        if self.mcfg.base_quant != "none":
            # quantize the frozen base once: the same numbers as the per-call
            # quantization, minus its pass in every forward and remat replay
            prequantize_model(self.model, self.mcfg.base_quant_min_dim)
        named = trainable_parameters(self.model)
        self.trainable = [p for _, p in named]
        self.trainable_names = [n for n, _ in named]
        dist_utils.broadcast_(self.trainable)  # every rank starts from rank 0's adapters
        total = sum(p.numel() for p in self.model.parameters())
        n_train = sum(p.numel() for p in self.trainable)
        stats = {"total_parameters": total, "trainable_parameters": n_train,
                 "trainable_percentage": 100.0 * n_train / total if total else 0.0}
        log.info("params: total=%s trainable=%s (%.2f%%)", f"{total:,}", f"{n_train:,}",
                 stats["trainable_percentage"])
        self.optimizer, self.sched = make_optimizer(self.tcfg, self.trainable, steps_per_epoch)
        return stats

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One optimizer update on a batch already on the device; returns the
        loss terms on the device."""
        # dropout masks from (seed, update, rank): a resumed run draws the same
        # ones, and each rank its own for its own images (rank 0 those of a
        # run without a group)
        with trace_span("sam3.train_step"):
            rank = multihost.process_index()
            self.model.seed_dropout((self.tcfg.seed * 1_000_003 + self.step
                                     + rank * 7_919_000_003) % 2**62)
            losses = train_step(self.model, batch, self.loss_cfg,
                                self.tcfg.gradient_accumulation_steps)
            with trace_span("sam3.update"):
                # The group's mean gradient: one all-reduce of one flat bucket
                # once the backward of every microbatch is done, as JAX reduces
                # once an update. Not DistributedDataParallel: its reducer hooks
                # fire per parameter inside a backward that replays remat
                # regions (ops/remat.py, SaveFirst), and accumulation would
                # need no_sync.
                dist_utils.all_reduce_mean_([p.grad for p in self.trainable
                                             if p.grad is not None])
                apply_update(self.optimizer, self.trainable, self.sched(self.step),
                             self.tcfg.max_grad_norm)
            self.step += 1
        return losses

    def _write_stats(self, name: str, record: Dict[str, Any]) -> None:
        if not multihost.is_primary():  # one writer under a group
            return
        with open(os.path.join(self.tcfg.output_dir, f"{name}.json"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def _batches(self, loader, epoch: int):
        stream = loader.epoch(epoch)
        if self.tcfg.device_prefetch > 0:
            return prefetch_to_device(stream, self.device, self.tcfg.device_prefetch)
        return (batch_to_device(b, self.device) for b in stream)

    def fit(self, train_loader, val_loader=None, num_epochs: Optional[int] = None) -> Dict[str, Any]:
        epochs = num_epochs or self.tcfg.num_epochs
        if not hasattr(self, "optimizer"):
            self.setup(steps_per_epoch=len(train_loader))
        best_val = float("inf")
        history: Dict[str, list] = {"train_loss": [], "val_loss": []}
        start_epoch = 0
        t_start = time.time()
        cuda = self.device.type == "cuda"
        tb = TensorBoardLogger(os.path.join(self.tcfg.output_dir, "tb")) if multihost.is_primary() \
            else None
        mem = MemMeter(self.device)

        state_path = os.path.join(self.tcfg.output_dir, "train_state.npz")
        dist_utils.barrier()  # no rank looks for the state before every rank is here
        if os.path.exists(state_path):  # auto-resume
            meta = self.load_state()
            start_epoch = meta.get("epoch", -1) + 1
            best_val = meta.get("best_val", best_val)
            log.info("resumed from %s at epoch %d step %d", state_path, start_epoch, self.step)

        for epoch in range(start_epoch, epochs):
            epoch_losses = []
            t_epoch = t_iter = time.time()
            t_data = 0.0
            for batch in self._batches(train_loader, epoch):
                t_step = time.time()
                t_data += t_step - t_iter
                losses = self.train_step(batch)
                if self.step % self.tcfg.logging_steps == 0 or self.step == 1:
                    if cuda:
                        torch.cuda.synchronize(self.device)
                    t_done = time.time()
                    names = list(losses)
                    stacked = torch.stack([losses[k].float() for k in names])
                    # the group's mean (one all-reduce), so every rank sees the
                    # same numbers and a NaN stops every rank at once
                    dist_utils.all_reduce_mean_([stacked])
                    values = stacked.cpu().tolist()
                    loss_np = dict(zip(names, values))  # one device-to-host copy
                    loss = loss_np["core_loss"]
                    if not np.isfinite(loss):
                        raise FloatingPointError(f"Loss is {loss} at step {self.step}")
                    epoch_losses.append(loss)
                    lr = self.sched(self.step)
                    log.info("epoch %d step %d loss %.4f lr %.2e data_t %.2fs",
                             epoch, self.step, loss, lr, t_data)
                    self._write_stats("train_stats", {
                        "epoch": epoch, "step": self.step, "loss": loss, "lr": lr,
                        "data_time_s": round(t_data, 3),
                        # host clock of this update, ending in a device sync
                        "step_time_s": round(t_done - t_step, 4),
                        "elapsed_s": round(time.time() - t_start, 1),
                        "mem_peak_gb": round(mem.peak_gb, 3),
                        **{f"loss/{k}": round(v, 5) for k, v in loss_np.items() if k != "core_loss"},
                    })
                    if tb is not None:
                        tb.log_dict(loss_np, self.step, prefix="loss/")
                        tb.log("lr", lr, self.step)
                t_iter = time.time()

            train_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
            history["train_loss"].append(train_loss)
            log.info("epoch %d done in %.1fs train_loss %.4f", epoch, time.time() - t_epoch,
                     train_loss)
            if val_loader is not None:
                val_loss = self.evaluate(val_loader)
                history["val_loss"].append(val_loss)
                self._write_stats("val_stats", {"epoch": epoch, "val_loss": val_loss,
                                                "train_loss": train_loss})
                if tb is not None:
                    tb.log("val_loss", val_loss, self.step)
                if val_loss < best_val:
                    best_val = val_loss
                    self.save_adapters("best_lora.npz")
            self.save_adapters("last_lora.npz")
            self.save_state(epoch=epoch, best_val=best_val)

        if tb is not None:
            tb.close()
        return {"history": history, "best_val_loss": best_val, "steps": self.step,
                "wall_s": time.time() - t_start}

    @torch.no_grad()
    def evaluate(self, val_loader) -> float:
        """Mean ``core_loss`` over the loader, dropout off; the matching and
        the matched masks run, since the batches carry targets. Under a
        group, the group's mean (every rank must take as many batches)."""
        self.model.eval()
        losses = []
        for batch in val_loader.epoch(0):
            batch = batch_to_device(batch, self.device)
            out = self.model(batch)
            losses.append(compute_losses(out, batch.targets, self.loss_cfg)["core_loss"])
        if not losses:
            return float("nan")
        mean = torch.stack(losses).mean()
        dist_utils.all_reduce_mean_([mean])
        return float(mean.cpu())

    def save_adapters(self, filename: str) -> str:
        """Adapter-only ``.npz`` in the JAX package's names, layout and
        channel order (JAX ``load_lora_weights`` reads it). Rank 0 alone
        writes."""
        path = os.path.join(self.tcfg.output_dir, filename)
        if not multihost.is_primary():
            return path
        tmp = path + ".tmp.npz"  # np.savez appends .npz to other suffixes
        save_lora_weights(self.model, tmp)
        os.replace(tmp, path)
        return path

    def save_state(self, filename: str = "train_state.npz", **meta) -> str:
        """Resumable state: the adapters and AdamW's moments and counts by
        parameter name, the update count and ``meta``. The frozen base is not
        saved; it reloads from its checkpoint. Rank 0 alone writes."""
        path = os.path.join(self.tcfg.output_dir, filename)
        if not multihost.is_primary():
            return path
        payload = {}
        for name, p in zip(self.trainable_names, self.trainable):
            payload[f"lora::{name}"] = p.detach().cpu().numpy()
            for k, v in self.optimizer.state.get(p, {}).items():
                payload[f"opt::{name}::{k}"] = torch.as_tensor(v).detach().cpu().numpy()
        payload["meta"] = np.frombuffer(
            json.dumps({"step": self.step, **meta}).encode(), dtype=np.uint8)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)
        return path

    def load_state(self, filename: str = "train_state.npz") -> Dict[str, Any]:
        """Restore what ``save_state`` wrote; returns its meta."""
        path = os.path.join(self.tcfg.output_dir, filename)
        with np.load(path) as data, torch.no_grad():
            for name, p in zip(self.trainable_names, self.trainable):
                p.copy_(torch.from_numpy(data[f"lora::{name}"]))
                state = {}
                for k in ("step", "exp_avg", "exp_avg_sq"):
                    key = f"opt::{name}::{k}"
                    if key in data.files:
                        v = torch.from_numpy(data[key])
                        # AdamW keeps its step count as a CPU float tensor
                        state[k] = v.float() if k == "step" else v.to(p.device)
                if state:
                    self.optimizer.state[p] = state
            meta = json.loads(data["meta"].tobytes().decode())
        self.step = meta.get("step", 0)
        return meta
