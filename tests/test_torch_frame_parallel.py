"""The port's ``FrameParallelDetector`` against the JAX package's, at one
rank on the CPU: the same batch-first detection function (written once for
each) over the same frames yields the same per-frame outputs in order,
with a partial last chunk, under the JAX mesh of 2 (or 4) devices and the
port's single rank at the same chunk size; both refuse a chunk that does
not divide over the data axis. The tiny model's ``_forward`` through the
detector equals it frame by frame (its rows index their own frames)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.parallel import make_mesh as jax_make_mesh
from sam3_lora_tpu.parallel.frame_parallel import FrameParallelDetector as JFrameParallelDetector
from sam3_lora_tpu_torch.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu_torch.inference import SAM3LoRAInference
from sam3_lora_tpu_torch.parallel import FrameParallelDetector, make_mesh


def jax_detect(params, images, token_ids):
    feat = jnp.mean(images, axis=(1, 2, 3)) * params["scale"]
    return {"scores": jax.nn.sigmoid(feat)[:, None] * jnp.arange(1.0, 5.0),
            "tok_sum": token_ids.sum(axis=-1), "first": images[:, 0, :2, :2]}


def port_detect(params, images, token_ids):
    feat = images.mean(dim=(1, 2, 3)) * params["scale"]
    return {"scores": torch.sigmoid(feat)[:, None] * torch.arange(1.0, 5.0),
            "tok_sum": token_ids.sum(-1), "first": images[:, 0, :2, :2]}


@pytest.mark.parametrize("n_frames,chunk,n_dev", [(19, 4, 2), (8, 4, 4), (3, 4, 2), (5, 1, 1)])
def test_yields_equal_jax(n_frames, chunk, n_dev):
    rng = np.random.RandomState(n_frames)
    frames = [rng.randn(3, 8, 8).astype(np.float32) for _ in range(n_frames)]
    toks = np.arange(5, dtype=np.int32)
    ref = list(JFrameParallelDetector(jax_detect, {"scale": jnp.float32(3.0)},
                                      mesh=jax_make_mesh(n_devices=n_dev),
                                      chunk_size=chunk).detect_video(frames, toks))
    got = list(FrameParallelDetector(port_detect, {"scale": 3.0}, chunk_size=chunk,
                                     device="cpu").detect_video(frames, toks.astype(np.int64)))
    assert len(got) == len(ref) == n_frames
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].shape == r[k].shape, k
            np.testing.assert_allclose(g[k], r[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_chunk_must_divide_over_the_data_axis():
    with pytest.raises(ValueError, match="divisible"):
        JFrameParallelDetector(lambda *a: None, {}, mesh=jax_make_mesh(n_devices=2), chunk_size=3)
    with pytest.raises(ValueError, match="divisible"):
        FrameParallelDetector(port_detect, {}, mesh=make_mesh(ranks=[0, 1]), chunk_size=3,
                              device="cpu")
    assert FrameParallelDetector(port_detect, {}, device="cpu").chunk == 1  # one rank


def test_forward_of_a_chunk_equals_each_frame_alone():
    eng = SAM3LoRAInference(tiny_model_config(), LoRAConfig(target_modules=("qkv", "fc1")),
                            device="cpu")
    rng = np.random.RandomState(0)
    frames = [eng.preprocess(rng.randint(0, 256, (40, 60, 3)).astype(np.uint8))[0][0]
              for _ in range(5)]
    ids = np.asarray(eng.tokenizer(["crack"], context_length=eng.cfg.text_context_length),
                     np.int64)[0]
    det = FrameParallelDetector(SAM3LoRAInference._forward, eng, chunk_size=4, device="cpu")
    outs = list(det.detect_video(frames, ids))
    assert len(outs) == 5
    for frame, out in zip(frames, outs):
        alone = eng._forward(torch.from_numpy(frame[None]), torch.from_numpy(ids[None]))
        for got, want in zip(out, alone):
            np.testing.assert_allclose(got, want[0].numpy(), rtol=1e-5, atol=1e-6)
