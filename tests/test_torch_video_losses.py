"""The port's video-tier losses (``train/video_losses.py``) against the JAX
package's, on the CPU in fp32 with the same seeded numpy inputs: every
value and its gradient with respect to the logits (``jax.grad`` beside
``torch.autograd.grad``) within rtol 1e-5, atol 1e-6.

* ``semantic_seg_loss``: BCE and focal; presence None, on and off; the
  union resized down (40^2 masks, 12^2 logits; JAX's resize antialiases)
  and up (12^2 -> 20^2).
* ``det2trk_assoc_loss`` with each false-positive option, and
  ``tracking_by_detection_assoc_loss``, with object ids that two tracks
  (or two detections) share: the first one is the label on both sides.
* ``point_sample``, and the uncertain points of
  ``get_uncertain_point_coords_with_randomness`` from JAX's own draws
  (``jax.random.split`` of the key, then ``uniform`` of each half) given to
  ``uncertain_point_coords``, equal to JAX's, also where the candidates'
  uncertainties tie (the lower index first, as ``jax.lax.top_k``);
  ``point_sampled_mask_loss`` on the same draws.

And chip_smoke's video-train drive rehearsed on the CPU at the tiny config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# torch.utils.checkpoint (the model's remat regions) imports torch._dynamo at
# its first use, ~3 s; a full run's collection has imported it already, so
# import it here too and the training step's time is its own
import torch._dynamo  # noqa: F401

import chip_smoke
from sam3_lora_tpu.train import video_losses as jvl
from sam3_lora_tpu_torch import config as tc
from sam3_lora_tpu_torch.models import build_sam3_image_model, init_model
from sam3_lora_tpu_torch.train import video_losses as tvl

from torch_port_helpers import count_card_entries

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def check_losses(jfn, tfn, inputs, keys, metrics=()):
    """``jfn`` and ``tfn`` map the differentiable ``inputs`` (numpy, fp32)
    to their dict of losses: each of ``keys`` and ``metrics`` equal, and
    the gradient of each of ``keys`` with respect to every input."""
    argnums = tuple(range(len(inputs)))

    def values_and_grads(*a):
        grads = [jax.grad(lambda *x, k=k: jfn(*x)[k], argnums=argnums)(*a) for k in keys]
        return jfn(*a), grads

    want, jac = jax.jit(values_and_grads)(*map(jnp.asarray, inputs))
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = tfn(*ts)
    assert set(keys) | set(metrics) <= set(got) and set(got) == set(want)
    for k in list(keys) + list(metrics):
        close(got[k].detach(), want[k], k)
    for i, k in enumerate(keys):
        grads = torch.autograd.grad(got[k], ts, retain_graph=True, allow_unused=True)
        for j, g in enumerate(grads):
            g = torch.zeros_like(ts[j]) if g is None else g
            close(g, jac[i][j], f"d {k} / d input {j}")


def disks(rng, b, t, size):
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((b, t, size, size), np.float32)
    for i in range(b):
        for j in range(t):
            cy, cx = rng.uniform(0, size, 2)
            r = rng.uniform(size / 8, size / 3)
            out[i, j] = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r)
    return out


@pytest.mark.parametrize("resize", ["down", "up"])
@pytest.mark.parametrize("presence", [None, "on", "off"])
@pytest.mark.parametrize("focal", [False, True])
def test_semantic_seg_loss_equals_jax(focal, presence, resize):
    rng = np.random.RandomState(0)
    b, t = 3, 2
    big, small = (40, 12) if resize == "down" else (12, 20)
    masks = disks(rng, b, t, big)
    masks[2] = 0.0                                     # a frame with no foreground
    valid = np.array([[True, False], [True, True], [False, True]])
    logits = (2.0 * rng.standard_normal((b, 1, small, small))).astype(np.float32)
    pres = rng.standard_normal((b, 1)).astype(np.float32)
    kw = dict(focal=focal, presence_loss=presence != "off")
    keys = ["loss_semantic_seg", "loss_semantic_dice"]
    metrics = ["miou_semantic_seg"]
    if presence is None:
        inputs = (logits,)

        def jfn(l):
            return jvl.semantic_seg_loss(l, jnp.asarray(masks), jnp.asarray(valid), **kw)

        def tfn(l):
            return tvl.semantic_seg_loss(l, torch.from_numpy(masks), torch.from_numpy(valid), **kw)
    else:
        inputs = (logits, pres)
        # off: the presence loss is a constant 0, with no gradient
        (keys if presence == "on" else metrics).append("loss_semantic_presence")
        metrics.append("presence_acc")

        def jfn(l, p):
            return jvl.semantic_seg_loss(l, jnp.asarray(masks), jnp.asarray(valid), p, **kw)

        def tfn(l, p):
            return tvl.semantic_seg_loss(l, torch.from_numpy(masks), torch.from_numpy(valid), p,
                                         **kw)
    check_losses(jfn, tfn, inputs, keys, metrics)
    got = tfn(*map(torch.from_numpy, inputs))
    if presence == "off":
        assert float(got["loss_semantic_presence"]) == 0.0 == float(got["presence_acc"])


def assoc_ids(rng, b, q_det, q_trk, n_obj):
    """Matched ids: -1 or an object id; track 1 repeats track 0's id and
    detection 1 detection 0's, where both are matched."""
    det = np.where(rng.rand(b, q_det) < 0.6, rng.randint(0, n_obj, (b, q_det)), -1)
    trk = np.where(rng.rand(b, q_trk) < 0.7, rng.randint(0, n_obj, (b, q_trk)), -1)
    trk[:, 1], det[:, 1] = trk[:, 0], det[:, 0]
    trk[0, 0] = trk[0, 1] = det[0, 0]                  # a shared id that a detection carries
    trk[-1] = -1                                       # a frame without tracks
    return det.astype(np.int32), trk.astype(np.int32)


@pytest.mark.parametrize("fp", ["none", "new_obj", "exhaustive_only", "every_frame"])
def test_det2trk_assoc_loss_equals_jax(fp):
    rng = np.random.RandomState(1)
    b, q_det, q_trk = 4, 9, 5
    det, trk = assoc_ids(rng, b, q_det, q_trk, 6)
    logits = (3.0 * rng.standard_normal((b, q_det, q_trk + 2))).astype(np.float32)
    pred = rng.standard_normal((b, q_det)).astype(np.float32)
    exhaustive = np.array([True, False, True, False])
    kw = dict(use_fp_loss=fp != "none", treat_fp_as_new_obj=fp == "new_obj",
              fp_loss_on_exhaustive_only=fp == "exhaustive_only")

    def jfn(l):
        return jvl.det2trk_assoc_loss(l, jnp.asarray(det), jnp.asarray(trk), jnp.float32(3.0),
                                      pred_logits=jnp.asarray(pred),
                                      is_exhaustive=jnp.asarray(exhaustive), **kw)

    def tfn(l):
        return tvl.det2trk_assoc_loss(l, torch.from_numpy(det), torch.from_numpy(trk), 3.0,
                                      pred_logits=torch.from_numpy(pred),
                                      is_exhaustive=torch.from_numpy(exhaustive), **kw)

    check_losses(jfn, tfn, (logits,), ["loss_det2trk_assoc"])


def test_assoc_label_is_the_first_track():
    """Uniform logits but for the first track of a shared id: the loss is
    that column's CE, whichever of the two tracks the logits favour."""
    det, trk = np.array([[7]]), np.array([[7, 7]])
    logits = np.zeros((1, 1, 4), np.float32)
    logits[0, 0, 0] = 5.0
    got = tvl.det2trk_assoc_loss(torch.from_numpy(logits), torch.from_numpy(det),
                                 torch.from_numpy(trk), 1.0)["loss_det2trk_assoc"]
    want = -np.log(np.exp(5.0) / (np.exp(5.0) + 3.0))
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("seed", [2, 3])
def test_tracking_by_detection_assoc_loss_equals_jax(seed):
    rng = np.random.RandomState(seed)
    b, q_det, q_trk = 3, 8, 6
    det, trk = assoc_ids(rng, b, q_det, q_trk, 5)
    logits = (3.0 * rng.standard_normal((b, q_det + 1, q_trk + 1))).astype(np.float32)

    def jfn(l):
        return jvl.tracking_by_detection_assoc_loss(l, jnp.asarray(det), jnp.asarray(trk),
                                                    jnp.float32(2.0))

    def tfn(l):
        return tvl.tracking_by_detection_assoc_loss(l, torch.from_numpy(det),
                                                    torch.from_numpy(trk), 2.0)

    check_losses(jfn, tfn, (logits,), ["loss_det2trk_assoc", "loss_trk2det_assoc"])


def test_point_sample_equals_jax():
    rng = np.random.RandomState(4)
    img = rng.standard_normal((2, 3, 7, 9)).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, (2, 50, 2)).astype(np.float32)  # some outside
    want = jax.jit(jvl.point_sample)(jnp.asarray(img), jnp.asarray(coords))
    jac = jax.jit(jax.grad(lambda i: (jvl.point_sample(i, jnp.asarray(coords)) ** 2).sum()))(
        jnp.asarray(img))
    ti = torch.tensor(img, requires_grad=True)
    got = tvl.point_sample(ti, torch.from_numpy(coords))
    close(got.detach(), want, "point_sample")
    (g,) = torch.autograd.grad((got ** 2).sum(), ti)
    close(g, jac, "d point_sample")


def point_logits(case):
    rng = np.random.RandomState(5)
    if case == "random":
        return (4.0 * rng.standard_normal((3, 1, 16, 16))).astype(np.float32)
    # ties: a constant interior (the candidates that sample only it tie),
    # zero padding outside, and a few distinct values
    logits = np.full((3, 1, 16, 16), 2.0, np.float32)
    logits[:, :, :3, :3] = 0.5
    return logits


@pytest.mark.parametrize("ratio", [0.75, 1.0])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_uncertain_points_equal_jax(case, ratio):
    logits = point_logits(case)
    key, num_points, over = jax.random.PRNGKey(7), 40, 3
    n_rand = num_points - int(num_points * ratio)

    def run(x):
        k1, k2 = jax.random.split(key)
        return (jvl.get_uncertain_point_coords_with_randomness(
                    x, key, num_points, oversample_ratio=over, importance_sample_ratio=ratio),
                jax.random.uniform(k1, (3, num_points * over, 2)),
                jax.random.uniform(k2, (3, n_rand, 2)))

    want, cand, rand = (np.array(x) for x in jax.jit(run)(jnp.asarray(logits)))
    got = tvl.uncertain_point_coords(torch.from_numpy(logits), torch.from_numpy(cand),
                                     torch.from_numpy(rand), num_points, ratio)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "ties":  # torch.topk's order differs from JAX's here, even on the CPU
        vals = -np.abs(tvl.point_sample(torch.from_numpy(logits), torch.from_numpy(cand)).numpy())[:, 0]
        assert (np.sort(vals, axis=1)[:, ::-1][:, :int(num_points * ratio)] == -2.0).any()
    drawn = tvl.get_uncertain_point_coords_with_randomness(
        torch.from_numpy(logits), num_points, over, ratio,
        generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, num_points, 2) and ((drawn >= 0) & (drawn <= 1)).all()


def point_loss_inputs(n=3):
    rng = np.random.RandomState(6)
    pred = (3.0 * rng.standard_normal((n, 12, 12))).astype(np.float32)
    return pred, disks(rng, 1, n, 30)[0]


@pytest.mark.parametrize("key", ["loss_mask", "loss_dice"])
def test_point_sampled_mask_loss_equals_jax(key):
    """Each loss and its gradient, and JAX's draws for the port, from one
    JAX compile a loss (the two losses together compile for longer than a
    fast test may take)."""
    pred, gt = point_loss_inputs()
    num_points, n_rand, rng = 48, 12, jax.random.PRNGKey(3)

    def jfn(p):
        return jvl.point_sampled_mask_loss(p, jnp.asarray(gt), jnp.float32(2.0), rng,
                                           num_points=num_points)[key]

    def run(p):
        k1, k2 = jax.random.split(rng)
        draws = (jax.random.uniform(k1, (len(pred), 3 * num_points, 2)),
                 jax.random.uniform(k2, (len(pred), n_rand, 2)))
        return jax.value_and_grad(jfn)(p), draws

    (want, want_grad), draws = jax.jit(run)(jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    got = tvl.point_sampled_mask_loss(tp, torch.from_numpy(gt), 2.0, num_points=num_points,
                                      draws=tuple(torch.from_numpy(np.array(x)) for x in draws))
    close(got[key].detach(), want, key)
    (g,) = torch.autograd.grad(got[key], tp)
    close(g, want_grad, f"d {key}")


def test_point_sampled_mask_loss_draws_from_the_generator():
    pred, gt = map(torch.from_numpy, point_loss_inputs())
    a, b, c = (tvl.point_sampled_mask_loss(pred, gt, 2.0, torch.Generator().manual_seed(s),
                                           num_points=48) for s in (1, 1, 2))
    assert all(torch.equal(a[k], b[k]) and torch.isfinite(a[k]) for k in a)
    assert not torch.equal(a["loss_mask"], c["loss_mask"])


@pytest.fixture
def counted(monkeypatch):
    count_card_entries(monkeypatch)
    chip_smoke.reset_counts()
    yield
    chip_smoke.reset_counts()


def test_chip_smoke_video_train_step_on_the_cpu(counted, tmp_path):
    """chip_smoke's video-train phase at the tiny config, on the CPU: a clip
    from make_synthetic_ytvis through the model in train mode, the video
    losses on its outputs and one backward; the launches of the forward
    and of the step the train phase's design, finite losses and adapter
    gradients, the losses and the sampler the same on both sides of
    ``card_against_cpu`` (here the CPU twice)."""
    cfg = tc.tiny_model_config(d_model=16, enc_heads=2, dec_heads=2, flash_attention_min_seq=16)
    clip = chip_smoke.video_clip(cfg, str(tmp_path))
    assert clip.frames.shape == (chip_smoke.VT_STAGES, 3, cfg.img_size, cfg.img_size)
    model = build_sam3_image_model(cfg, lora=chip_smoke.LORA, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    chip_smoke.live_adapters(model, torch.Generator().manual_seed(1))
    res = chip_smoke.video_train_step(model, cfg, clip, "cpu")
    chip_smoke.check_video_train("video-train", cfg, res)
    assert res["pairs"] > 0 and res["nonzero"] > 0
    assert all(e == 0.0 and ge == 0.0 for _, e, ge in res["cpu"].values())
    assert set(res["points"]) == {cfg.mask_loss_resolution, cfg.img_size}
