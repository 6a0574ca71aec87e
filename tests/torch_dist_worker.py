"""One rank of the port's 2-process data-parallel test
(``tests/test_torch_parallel.py``), and the one-process references it is
held against.

Run as a rank: ``MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> WORLD_SIZE=2
RANK=<r> python tests/torch_dist_worker.py <dir>`` after ``make_data(<dir>)``:
``Trainer.fit`` on the tiny config over ``<dir>/data`` (batch 2 a rank, the
rank's host shard, the adapters written to ``<dir>/out`` by rank 0 alone),
then the rank's adapters to ``<dir>/adapters_rank<r>.npz`` and the
frame-parallel detector's outputs over both ranks to
``<dir>/frames_rank<r>.npy``. With a second argument ``cuda`` (two ranks
on one card): the bucketed mean and broadcast and the frame-parallel
all-gather under gloo on CUDA tensors, checked in the rank.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sam3_lora_tpu_torch.config import LoRAConfig, TrainConfig, tiny_model_config  # noqa: E402

LORA = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "linear1"))
TCFG = TrainConfig(batch_size=2, num_epochs=1, learning_rate=1e-3, warmup_steps=0,
                   lr_scheduler="constant", logging_steps=1, num_workers=1, seed=0)
N_IMAGES, STEPS, WORLD = 8, 2, 2  # 8 images over 2 ranks at batch 2: 2 updates
N_FRAMES, CHUNK = 7, 4


def make_data(base: str) -> str:
    from sam3_lora_tpu_torch.train.data import make_synthetic_coco

    root = os.path.join(base, "data")
    make_synthetic_coco(root, "train", num_images=N_IMAGES, img_size=64, seed=1)
    make_synthetic_coco(root, "valid", num_images=2, img_size=64, seed=2)
    return root


def _trainer(out_dir: str, batch_size: int, steps_per_epoch: int):
    from sam3_lora_tpu_torch.train.trainer import Trainer

    tcfg = dataclasses.replace(TCFG, batch_size=batch_size, output_dir=out_dir)
    trainer = Trainer(tiny_model_config(), LORA, tcfg, device="cpu")
    trainer.setup(steps_per_epoch=steps_per_epoch)
    trainer.model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0  # the ranks' masks differ
    return trainer


def _dataset(base: str, split: str):
    from sam3_lora_tpu_torch.train.data import COCOSegmentDataset

    return COCOSegmentDataset(os.path.join(base, "data"), split, model_config=tiny_model_config())


def _adapters(model) -> dict:
    from sam3_lora_tpu_torch.models.lora import lora_state

    return {k: np.asarray(v) for k, v in lora_state(model).items()}


class _GlobalBatches:
    """The batches the two ranks step together, each as one batch of 4:
    rank 0's i-th batch, then rank 1's."""

    def __init__(self, ds):
        from sam3_lora_tpu_torch.parallel.multihost import HostShard
        from sam3_lora_tpu_torch.train.data import DataLoader

        self.ds = ds
        self.orders = [DataLoader(ds, TCFG.batch_size, seed=TCFG.seed, tokenizer=object(),
                                  host_shard=HostShard(r, WORLD)).order(0) for r in range(WORLD)]

    def __len__(self):
        return STEPS

    def epoch(self, epoch: int = 0):
        from sam3_lora_tpu_torch.train.data import collate

        bs = TCFG.batch_size
        for i in range(STEPS):
            idx = [j for order in self.orders for j in order[i * bs:(i + 1) * bs]]
            yield collate([self.ds.load(j, epoch=epoch) for j in idx], cfg=self.ds.cfg)


def fit_whole_batch(out_dir: str) -> dict:
    """One process, no group, the two ranks' batches as one: its adapters."""
    base = os.path.dirname(out_dir)
    loader = _GlobalBatches(_dataset(base, "train"))
    trainer = _trainer(out_dir, WORLD * TCFG.batch_size, len(loader))
    trainer.fit(loader)
    return _adapters(trainer.model)


def _detect(scale, images, token_ids):
    feat = images.float().mean(dim=(1, 2, 3)) * scale
    return {"scores": torch.sigmoid(feat)[:, None] * torch.ones(1, 4, device=images.device),
            "tok_sum": token_ids.sum(-1)}


def _frames():
    rng = np.random.RandomState(0)
    return [rng.randn(3, 8, 8).astype(np.float32) for _ in range(N_FRAMES)], np.arange(5)


def frames_reference() -> np.ndarray:
    frames, toks = _frames()
    images = torch.from_numpy(np.stack(frames))
    return _detect(3.0, images, torch.from_numpy(np.broadcast_to(toks, (N_FRAMES, 5)).copy()))[
        "scores"].numpy()


def write_cli_config(base: str) -> str:
    data = make_data(base)
    path = os.path.join(base, "config.yaml")
    with open(path, "w") as f:
        f.write(
            "model:\n  tiny: true\n"
            "lora:\n  rank: 4\n  alpha: 8\n  target_modules: [fc1]\n"
            f"training:\n  data_dir: {data}\n  batch_size: 2\n  num_epochs: 1\n"
            "  warmup_steps: 0\n  logging_steps: 1\n  num_workers: 1\n  learning_rate: 1e-3\n"
            f"output:\n  output_dir: {os.path.join(base, 'out')}\n"
        )
    return path


def main(base: str) -> None:
    from sam3_lora_tpu_torch.parallel import FrameParallelDetector, multihost
    from sam3_lora_tpu_torch.train.data import DataLoader

    assert multihost.initialize(backend="gloo")
    rank = multihost.process_index()
    try:
        ds = _dataset(base, "train")
        loader = DataLoader(ds, TCFG.batch_size, seed=TCFG.seed, num_workers=1,
                            host_shard=multihost.host_shard())
        val = DataLoader(_dataset(base, "valid"), TCFG.batch_size, shuffle=False, num_workers=1)
        trainer = _trainer(os.path.join(base, "out"), TCFG.batch_size, len(loader))
        result = trainer.fit(loader, val)
        assert result["steps"] == STEPS, result
        np.savez(os.path.join(base, f"adapters_rank{rank}.npz"), **_adapters(trainer.model))

        frames, toks = _frames()
        det = FrameParallelDetector(_detect, 3.0, chunk_size=CHUNK, device="cpu")
        outs = list(det.detect_video(frames, toks))
        assert len(outs) == N_FRAMES
        np.save(os.path.join(base, f"frames_rank{rank}.npy"), np.stack([o["scores"] for o in outs]))
    finally:
        multihost.shutdown()
    print(f"WORKER_OK rank={rank}", flush=True)


def cuda_collectives() -> None:
    from sam3_lora_tpu_torch.parallel import FrameParallelDetector, dist_utils, multihost

    assert multihost.initialize(backend="gloo")
    rank = multihost.process_index()
    try:
        t = torch.full((3,), float(rank + 1), device="cuda")
        dist_utils.all_reduce_mean_([t])
        assert torch.equal(t.cpu(), torch.full((3,), 1.5)), t
        b = torch.full((2, 2), float(rank + 7), device="cuda")
        dist_utils.broadcast_([b])
        assert torch.equal(b.cpu(), torch.full((2, 2), 7.0)), b
        frames, toks = _frames()
        outs = list(FrameParallelDetector(_detect, 3.0, chunk_size=CHUNK).detect_video(frames, toks))
        np.testing.assert_allclose(np.stack([o["scores"] for o in outs]), frames_reference(),
                                   rtol=1e-5)
    finally:
        multihost.shutdown()
    print(f"WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    if sys.argv[2:] == ["cuda"]:
        cuda_collectives()
    else:
        main(sys.argv[1])
