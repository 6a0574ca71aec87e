"""The port's learning-rate schedules and gradient clip against the JAX
trainer's optax ones: the schedule at every update of a run (fp32
rounding, 1e-6 relative), and the clip below and above its threshold
(optax scales by max/norm only when norm >= max; 1e-6 relative)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sam3_lora_tpu.config import TrainConfig
from sam3_lora_tpu.train import trainer as jax_trainer
from sam3_lora_tpu_torch.train import trainer as port_trainer


@pytest.mark.parametrize("sched,warmup,epochs,accum", [
    ("cosine", 5, 3, 1), ("cosine", 0, 2, 1), ("cosine", 200, 1, 2),
    ("inverse_sqrt", 4, 2, 1), ("inverse_sqrt", 0, 2, 1), ("constant", 3, 1, 1),
])
def test_schedule_matches_optax_at_every_update(sched, warmup, epochs, accum):
    cfg = TrainConfig(lr_scheduler=sched, warmup_steps=warmup, num_epochs=epochs,
                      gradient_accumulation_steps=accum, learning_rate=3e-4)
    steps_per_epoch = 7
    ref = jax_trainer.make_lr_schedule(cfg, steps_per_epoch)
    port = port_trainer.make_lr_schedule(cfg, steps_per_epoch)
    for step in range(epochs * steps_per_epoch + 3):
        want = float(ref(jnp.asarray(step)))
        assert port(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step
    if warmup and sched != "constant":
        assert port(0) == 0.0  # under warmup the first update takes lr 0


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.RandomState(0)
    grads = [rng.standard_normal(s).astype(np.float32) * scale for s in ((4, 3), (7,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = port_trainer.clip_by_global_norm_(params, 1.0)
    assert norm.item() == pytest.approx(float(np.sqrt(sum((g ** 2).sum() for g in grads))), rel=1e-6)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6, atol=1e-9)
