"""The port's ``video.py`` against the JAX package's, on the CPU at the tiny
config, fp32 on both sides.

* The state machine and the heuristic tail, live against JAX on seeded
  inputs: ``associate_and_update`` (spawn, refresh, keep-alive, retirement,
  fresh ids, slot exhaustion, and random detections against random
  states), ``fill_holes_in_mask_scores`` (a batch, the lone-object rule,
  disabled at area 0), ``suppress_by_recent_occlusion`` (both orders),
  ``plan_reconditioning`` / ``apply_reconditioning`` (the periodic and the
  box trigger, a low-score track, at frames on and off the cadence).
  Discrete fields equal; float fields within 1e-4.
* ``make_tracker_fns`` over a ``TrackerCore`` with the same seeded weights
  (a JAX tree filled from numpy, through the weight bridge) on a seeded
  state whose slots cover a full ring with a frame past the window, a
  pointer-only bank, a dead slot and a fresh one: ``propagate``'s masks,
  tokens, object logits and IoU within 1e-4, ``update_memory``'s banks
  within 1e-4 and its ages equal.
* ``VideoGrounder.step`` over 10-12 frames with the processor's and the
  tracker's weights shared with JAX: with propagation (3 slots, 3 memory
  frames, 4 pointers: slot exhaustion at 12 detections, ring eviction,
  and a retirement at frame 9), with propagation and the heuristic tail
  on, and without propagation. Each frame's live ids, output masks and
  every discrete state field equal; scores, mask logits, memory banks and
  pointers within 2e-4 (the processor-level tolerance). The frames are
  40x60, the processor test's shape; the port's resize
  (``inference.py::preprocess_image``) gives PIL's pixels at every shape
  (``test_torch_inference.py``).

The JAX results of the tracker stages and the grounder runs are stored in
``tests/data/torch_ref_video.npz`` (the JAX grounder jits for ~10 s a
run); ``test_reference_is_current`` (slow) recomputes them. Rewrite:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_video.py``.

Also: chip_smoke's video checks rehearsed with the CPU on both sides."""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu import video as jvideo
from sam3_lora_tpu.ops import masks as jmasks
from sam3_lora_tpu_torch import video as tvideo

from torch_port_helpers import (
    fill_params, jax_tiny_processor, jax_video_tracker, load_reference, nested,
    port_tiny_processor, save_reference,
)

TOL = 1e-4
RUN_TOL = 2e-4
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_ref_video.npz")
NM, NP = 3, 4  # memory frames, pointers
FRAMES = [np.random.RandomState(10 + i).randint(0, 256, (40, 60, 3)).astype(np.uint8)
          for i in range(12)]
PROMPT = "object"
RUNS = {  # VideoGrounder kwargs and frame count
    "prop": (dict(num_slots=3, prob_threshold=0.0, propagate=True), 12),
    "tail": (dict(num_slots=4, prob_threshold=0.0, propagate=True, occlusion_suppression_iou=0.3,
                  recondition_every=3, recondition_bbox_iou=0.5, recondition_det_score=0.0), 10),
    "noprop": (dict(num_slots=3, prob_threshold=0.2), 10),
}
OUT = ("obj_ids", "scores", "masks_lowres")
DISCRETE = ("alive", "obj_ids", "maskmem_age", "obj_ptr_age", "missing_frames", "hotstart",
            "last_occluded", "frame_idx", "next_id")


# ---------------------------------------------------------------------------
# state helpers
# ---------------------------------------------------------------------------


def _blob(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.float32)


def _np_state(st) -> dict:
    return {k: np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()
            for k, v in st._asdict().items()}


def to_jax(st: dict):
    return jvideo.TrackState(**{k: jnp.asarray(v) for k, v in st.items()})


def to_port(st: dict):
    return tvideo.TrackState(**{k: torch.from_numpy(np.array(v)) for k, v in st.items()})


def assert_states(got, want, tol=TOL, tag=""):
    got, want = (x if isinstance(x, dict) else _np_state(x) for x in (got, want))
    for k in tvideo.TrackState._fields:
        if k in DISCRETE:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{tag}{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=f"{tag}{k}")


def tiny_state(k=4, hw=32, seed=0):
    rng = np.random.RandomState(seed)
    st = _np_state(jvideo.init_track_state(k, (hw, hw), num_maskmem=2, max_obj_ptrs=2, mem_dim=8,
                                           d_model=32, feat_hw=(4, 4)))
    st["alive"] = rng.rand(k) > 0.3
    st["obj_ids"] = np.where(st["alive"], np.arange(k), -1).astype(np.int32)
    st["masks"] = np.stack([_blob(hw, hw, *rng.randint(6, hw - 6, 2), rng.randint(3, 8)) * 10 - 5
                            for _ in range(k)]).astype(np.float32)
    st["scores"] = rng.rand(k).astype(np.float32)
    st["maskmem_age"] = rng.randint(-1, 3, (k, 2)).astype(np.int32)
    st["missing_frames"] = rng.randint(0, 4, k).astype(np.int32)
    st["hotstart"] = rng.randint(0, 5, k).astype(np.int32)
    st["last_occluded"] = rng.randint(-1, 6, k).astype(np.int32)
    st["frame_idx"] = np.int32(6)
    st["next_id"] = np.int32(k)
    return st


def dets(*blobs, scores, n_pad=6, hw=32):
    masks = np.zeros((n_pad, hw, hw), np.float32)
    s = np.zeros((n_pad,), np.float32)
    v = np.zeros((n_pad,), bool)
    for i, (b, sc) in enumerate(zip(blobs, scores)):
        masks[i], s[i], v[i] = b, sc, True
    return masks, s, v


_JITTED = {}


def _jax_assoc(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(partial(jvideo.associate_and_update, **kw))
    return _JITTED[key]


def both_assoc(st: dict, masks, scores, valid, **kw):
    """-> (the port's state, JAX's) after one associate_and_update."""
    want = _jax_assoc(**kw)(to_jax(st), jnp.asarray(masks), jnp.asarray(scores),
                            jnp.asarray(valid))
    got = tvideo.associate_and_update(to_port(st), torch.from_numpy(masks),
                                      torch.from_numpy(scores), torch.from_numpy(valid), **kw)
    return got, want


# ---------------------------------------------------------------------------
# the state machine and the heuristic tail, live against JAX
# ---------------------------------------------------------------------------


def test_spawn_track_retire_lifecycle_equals_jax():
    st = _np_state(jvideo.init_track_state(4, (32, 32), num_maskmem=2, max_obj_ptrs=2, mem_dim=8,
                                           d_model=32, feat_hw=(4, 4)))
    a, b, a2 = _blob(32, 32, 8, 8, 5), _blob(32, 32, 24, 24, 5), _blob(32, 32, 9, 9, 5)
    c = _blob(32, 32, 16, 28, 3)
    steps = [((a, b), [0.9, 0.8], {}), ((a2,), [0.85], dict(max_missing_frames=1))]
    steps += [((a2,), [0.85], dict(max_missing_frames=1))] * 3 + [((a2, c), [0.85, 0.7], {})]
    for i, (blobs, scores, kw) in enumerate(steps):
        got, want = both_assoc(st, *dets(*blobs, scores=scores), **kw)
        assert_states(got, want, tag=f"step {i}: ")
        st = _np_state(want)
    alive_ids = set(st["obj_ids"][st["alive"]].tolist())
    assert 0 in alive_ids and len(alive_ids) == 2 and max(alive_ids) >= 2  # id 1 not reused


def test_slot_exhaustion_equals_jax():
    st = _np_state(jvideo.init_track_state(2, (32, 32), num_maskmem=2, max_obj_ptrs=2, mem_dim=8,
                                           d_model=32, feat_hw=(4, 4)))
    blobs = [_blob(32, 32, 5 + 9 * i, 5 + 9 * i, 3) for i in range(3)]
    got, want = both_assoc(st, *dets(*blobs, scores=[0.9, 0.8, 0.7]))
    assert_states(got, want)
    assert int(got.alive.sum()) == 2 and int(got.next_id) == 2


@pytest.mark.parametrize("seed", range(4))
def test_associate_and_update_random_equals_jax(seed):
    """Random detections (some copies of live tracks, some fewer rows than
    slots) against a random state, with and without a spawn threshold."""
    rng = np.random.RandomState(100 + seed)
    st = tiny_state(k=5, seed=seed)
    n = 3 if seed % 2 else 8
    masks = np.stack([_blob(32, 32, *rng.randint(6, 26, 2), rng.randint(3, 8)) * 2 - 1
                      for _ in range(n)]).astype(np.float32)
    masks[0] = st["masks"][0]
    got, want = both_assoc(st, masks, rng.rand(n).astype(np.float32), rng.rand(n) > 0.2,
                           new_det_thresh=0.3 if seed < 2 else 0.0, max_missing_frames=2)
    assert_states(got, want)


def test_fill_holes_batch_equals_jax():
    rng = np.random.RandomState(3)
    m = np.full((5, 24, 24), -5.0, np.float32)
    m[0, 4:20, 4:20] = 5.0
    m[0, 10:12, 10:12] = -5.0      # a 4-pixel hole
    m[1, 4:16, 4:16] = 5.0
    m[1, 20:22, 20:22] = 5.0       # a sprinkle
    m[2, 10:13, 10:13] = 5.0       # a lone tiny object: kept
    m[3:] = rng.standard_normal((2, 24, 24)) * 3
    for area in (16, 40):
        want = np.asarray(jax.jit(partial(jvideo.fill_holes_in_mask_scores, max_area=area))(
            jnp.asarray(m)))
        got = tvideo.fill_holes_in_mask_scores(torch.from_numpy(m), area).numpy()
        np.testing.assert_array_equal(got, want)
    assert (got[0, 10:12, 10:12] > 0).all() and (got[1, 20:22, 20:22] < 0).all()
    assert (got[2, 10:13, 10:13] > 0).all()
    np.testing.assert_array_equal(tvideo.fill_holes_in_mask_scores(torch.from_numpy(m), 0).numpy(),
                                  m)
    # leading dims and one mask at a time give the same
    np.testing.assert_array_equal(
        tvideo.fill_holes_in_mask_scores(torch.from_numpy(m[3]), 16).numpy(),
        tvideo.fill_holes_in_mask_scores(torch.from_numpy(m), 16).numpy()[3])


def _overlapping(occ0, occ1):
    st = tiny_state()
    blob = _blob(32, 32, 16, 16, 8) * 10 - 5
    st.update(alive=np.array([True, True, False, True]),
              masks=np.stack([blob, blob, blob, np.full((32, 32), -5.0)]).astype(np.float32),
              last_occluded=np.array([occ0, occ1, 2, -1], np.int32), frame_idx=np.int32(7))
    return st


@pytest.mark.parametrize("occ", [(3, 5), (5, 3), (-1, 4), (-1, -1), (2, 2)])
@pytest.mark.parametrize("reverse", [False, True])
def test_suppress_by_recent_occlusion_equals_jax(occ, reverse):
    st = _overlapping(*occ)
    want = jax.jit(partial(jvideo.suppress_by_recent_occlusion, iou_threshold=0.5,
                           reverse=reverse))(to_jax(st))
    got = tvideo.suppress_by_recent_occlusion(to_port(st), 0.5, reverse=reverse)
    assert_states(got, want)
    if occ == (3, 5) and not reverse:  # the more recently occluded loses
        assert (got.masks[1] == tvideo.NO_OBJ_LOGIT).all() and int(got.last_occluded[1]) == 7
        assert int(got.last_occluded[3]) == 7  # empty mask: occluded


@pytest.mark.parametrize("frame", [6, 7])
@pytest.mark.parametrize("kw", [dict(recondition_every=3), dict(bbox_iou_thresh=0.9),
                                dict(bbox_iou_thresh=0.9, det_score_thresh=0.95),
                                dict(recondition_every=2, obj_score_thresh=0.99)])
def test_reconditioning_equals_jax(frame, kw):
    st = tiny_state(seed=5)
    st["alive"][:] = True
    st["scores"] = np.array([0.95, 0.9, 0.5, 0.99], np.float32)
    st["frame_idx"] = np.int32(frame)
    dm = np.concatenate([st["masks"][:3], -st["masks"][3:]]).copy()
    dm[1] = np.roll(dm[1], 3, axis=1)   # a shifted copy: its box IoU drops
    ds = np.array([0.95, 0.9, 0.85, 0.3], np.float32)
    nd = np.array([False, False, False, True])
    iou = np.array(jmasks.mask_iou(jnp.asarray(dm) > 0, jnp.asarray(st["masks"]) > 0))
    jrec, jdet = jax.jit(partial(jvideo.plan_reconditioning, **kw))(
        to_jax(st), jnp.asarray(dm), jnp.asarray(ds), jnp.asarray(nd), jnp.asarray(iou))
    rec, det = tvideo.plan_reconditioning(to_port(st), torch.from_numpy(dm), torch.from_numpy(ds),
                                          torch.from_numpy(nd), torch.from_numpy(iou), **kw)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))
    want = jvideo.apply_reconditioning(to_jax(st), jnp.asarray(dm), jrec, jdet)
    got = tvideo.apply_reconditioning(to_port(st), torch.from_numpy(dm), rec, det)
    assert_states(got, want)


def test_a_reconditioning_case_triggers():
    """The cases above are not all no-ops: the periodic trigger on its
    cadence reconditions the high-score slots with a matching detection."""
    st = tiny_state(seed=5)
    st["alive"][:] = True
    st["scores"] = np.array([0.95, 0.9, 0.5, 0.99], np.float32)
    dm = st["masks"].copy()
    iou = np.eye(4, dtype=np.float32)
    rec, det = tvideo.plan_reconditioning(to_port(st), torch.from_numpy(dm),
                                          torch.full((4,), 0.9), torch.zeros(4, dtype=torch.bool),
                                          torch.from_numpy(iou), recondition_every=3)
    assert rec.tolist() == [True, True, False, True] and det.tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the tracker stages and the grounder, against stored JAX results
# ---------------------------------------------------------------------------


def tracker_inputs(cfg):
    """A seeded 4-slot state and one frame's features: slot 0 a cond frame
    and a full ring with one frame past the window, slot 1 pointers only,
    slot 2 dead, slot 3 fresh (no memory)."""
    rng = np.random.RandomState(7)
    d, fh, mr = cfg.d_model, cfg.img_size // cfg.patch_size, cfg.mask_loss_resolution
    mem = max(d // 4, 8)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    st = _np_state(jvideo.init_track_state(4, (mr, mr), NM, NP, mem, d, (fh, fh)))
    st.update(alive=np.array([True, True, False, True]), obj_ids=np.array([0, 1, -1, 2], np.int32),
              masks=f(4, mr, mr), scores=rng.rand(4).astype(np.float32),
              maskmem=f(4, NM, mem, fh, fh), obj_ptrs=f(4, NP, d),
              maskmem_age=np.array([[4, 1, 3], [-1, -1, -1], [-1, -1, -1], [-1, -1, -1]], np.int32),
              obj_ptr_age=np.array([[0, 2, 1, 3], [1, -1, 0, -1], [-1] * 4, [-1] * 4], np.int32),
              frame_idx=np.int32(5), next_id=np.int32(3))
    feats = {"vis": f(1, d, fh, fh), "pos": f(1, d, fh, fh), "hi0": f(1, d, 4 * fh, 4 * fh),
             "hi1": f(1, d, 2 * fh, 2 * fh)}
    upd = {"masks": f(4, mr, mr), "obj_logits": np.array([10.0, -10.0, -10.0, 3.0], np.float32),
           "tokens": f(4, d)}
    return st, feats, upd


PROP = ("masks", "tokens", "obj_logits", "iou")


def jax_tracker_reference(jproc, tparams):
    from sam3_lora_tpu.models.layers import Spec
    from sam3_lora_tpu.models.tracker import TrackerCore

    cfg = jproc.cfg
    d, fh = cfg.d_model, cfg.img_size // cfg.patch_size
    core = TrackerCore(Spec(model=cfg, lora=None), d_model=d, mem_dim=max(d // 4, 8),
                       num_maskmem=NM, max_obj_ptrs=NP, feat_sizes=(fh, fh))
    prop, upd = (jax.jit(fn) for fn in jvideo.make_tracker_fns(core, NM, NP))
    st, feats, u = tracker_inputs(cfg)
    x = {k: jnp.asarray(v) for k, v in feats.items()}
    out = prop(tparams, to_jax(st), x["vis"], x["pos"], x["hi0"], x["hi1"])
    res = {f"propagate/{k}": np.asarray(v) for k, v in zip(PROP, out)}
    new = upd(tparams, to_jax(st), x["vis"], jnp.asarray(u["masks"]), jnp.asarray(u["obj_logits"]),
              jnp.asarray(u["tokens"]))
    res.update({f"update/{k}": v for k, v in _np_state(new).items()})
    return res


def run_grounder(vg, n):
    outs, states = [], []
    for frame in FRAMES[:n]:
        outs.append(vg.step(frame, PROMPT))
        states.append(_np_state(vg.state))
    return outs, states


def jax_reference():
    """-> (processor specs, tracker specs, {name: array})."""
    jproc, specs = jax_tiny_processor()
    tparams, tspecs = jax_video_tracker(jproc, NM, NP)
    res = jax_tracker_reference(jproc, tparams)
    for run, (kw, n) in RUNS.items():
        vg = jvideo.VideoGrounder(jproc, num_maskmem=NM, max_obj_ptrs=NP,
                                  tracker_params=tparams if kw.get("propagate") else None, **kw)
        outs, states = run_grounder(vg, n)
        for i, (o, s) in enumerate(zip(outs, states)):
            res.update({f"{run}/{i}/out/{k}": np.asarray(o[k]) for k in OUT})
            res.update({f"{run}/{i}/state/{k}": v for k, v in s.items()})
    return specs, tspecs, res


def port_grounder(specs, tspecs, run):
    kw, _ = RUNS[run]
    proc = port_tiny_processor(specs)
    tp = nested(fill_params(tspecs, seed=1)) if kw.get("propagate") else None
    return tvideo.VideoGrounder(proc, num_maskmem=NM, max_obj_ptrs=NP, tracker_params=tp, **kw)


def check_run(vg, run, want):
    _, n = RUNS[run]
    outs, states = run_grounder(vg, n)
    for i, (o, s) in enumerate(zip(outs, states)):
        w = {k: want[f"{run}/{i}/out/{k}"] for k in OUT}
        np.testing.assert_array_equal(o["obj_ids"], w["obj_ids"], err_msg=f"{run} frame {i}")
        np.testing.assert_allclose(o["scores"], w["scores"], rtol=RUN_TOL, atol=RUN_TOL)
        flips = o["masks_lowres"] != w["masks_lowres"]
        if flips.any():  # report how near the threshold the flipped pixels sat
            logits = want[f"{run}/{i}/state/masks"][want[f"{run}/{i}/state/alive"]]
            raise AssertionError(f"{run} frame {i}: {int(flips.sum())} output pixels differ, "
                                 f"their |JAX logit| at most {np.abs(logits[flips]).max():.3e}")
        assert_states(s, {k: want[f"{run}/{i}/state/{k}"] for k in tvideo.TrackState._fields},
                      tol=RUN_TOL, tag=f"{run} frame {i}: ")
    return outs, states


def _load():
    specs, arrays = load_reference(REF)
    n = int(arrays.pop("n_processor_params"))
    return specs[:n], specs[n:], arrays


@pytest.fixture(scope="module")
def ref():
    return _load()


def port_tracker(tspecs, cfg):
    return tvideo.video_tracker_core(cfg, torch.device("cpu"), NM, NP,
                                     nested(fill_params(tspecs, seed=1)))


def test_tracker_fns_match_jax(ref):
    from sam3_lora_tpu_torch import config as tc

    _, tspecs, want = ref
    cfg = tc.tiny_model_config()
    prop, upd = tvideo.make_tracker_fns(port_tracker(tspecs, cfg), NM, NP)
    st, feats, u = tracker_inputs(cfg)
    x = {k: torch.from_numpy(v) for k, v in feats.items()}
    out = prop(to_port(st), x["vis"], x["pos"], x["hi0"], x["hi1"])
    for k, v in zip(PROP, out):
        np.testing.assert_allclose(v.numpy(), want[f"propagate/{k}"], rtol=TOL, atol=TOL, err_msg=k)
    new = upd(to_port(st), x["vis"], *(torch.from_numpy(u[k]) for k in ("masks", "obj_logits",
                                                                         "tokens")))
    assert_states(new, {k: want[f"update/{k}"] for k in tvideo.TrackState._fields})
    # the slots the design means to cover: a window drop, a pointer-only
    # bank, a dead slot (all keys kept) and a fresh one (no memory)
    _, _, mmask, n_ptr, has_mem = tvideo.memory_bank(port_tracker(tspecs, cfg), to_port(st), NM, NP)
    assert has_mem.tolist() == [True, False, False, False] and n_ptr == NP * 4
    assert not mmask[2].any() and mmask[1, :-n_ptr].all() and not mmask[1, -n_ptr:].all()


@pytest.mark.parametrize("run", list(RUNS))
def test_grounder_matches_jax(ref, run):
    specs, tspecs, want = ref
    outs, states = check_run(port_grounder(specs, tspecs, run), run, want)
    if run == "prop":
        # 12 detections for 3 slots; the ring of 2 evicts; a retirement
        alive = [s["alive"].sum() for s in states]
        assert alive[0] == 3 and states[-1]["next_id"] > 3
        assert any((s["maskmem_age"][:, 1:] >= 0).all() and (s["hotstart"] >= NM).any()
                   for s in states)
        assert all(len(set(o["obj_ids"].tolist())) == len(o["obj_ids"]) for o in outs)


def test_chip_smoke_video_checks_on_the_cpu(ref):
    """chip_smoke's video checks, with the CPU on both sides: the tracker
    stages equal, association and the components bit for bit, the state
    checks pass on a grounder run and refuse a broken state."""
    import chip_smoke

    specs, tspecs, _ = ref
    vg = port_grounder(specs, tspecs, "prop")
    run_grounder(vg, 5)
    chip_smoke.check_track_state("cpu", vg.state, NM, NP)
    feats, poss = vg.proc._state["feats"], vg.proc._state["poss"]
    live = torch.nonzero(vg.state.alive).flatten()[:2]
    res = chip_smoke.tracker_against_cpu(vg.core, vg.state, feats, poss, live)
    assert res["ages_equal"] and not res["index_flips"]
    assert all(v <= 1e-6 for v in res.values() if isinstance(v, float)), res
    dets_ = vg.proc.set_text_prompt(PROMPT, threshold=-1.0)
    dm = torch.from_numpy(dets_["masks_lowres"].astype(np.float32))
    ds = torch.from_numpy(dets_["scores"].astype(np.float32))
    eq, rounds = chip_smoke.video_ops_against_cpu(dm, ds, ds >= 0, vg.state)
    assert all(eq.values()) and rounds >= 1
    broken = vg.state._replace(obj_ids=torch.where(vg.state.alive, 0, -1).int())
    with pytest.raises(AssertionError, match="ids"):
        chip_smoke.check_track_state("cpu", broken, NM, NP)


def test_reference_is_current():
    specs, tspecs, live = jax_reference()
    s_specs, s_tspecs, want = _load()
    same = lambda a, b: [(".".join(p), tuple(s)) for p, s in a] == \
        [(".".join(p), tuple(s)) for p, s in b]  # noqa: E731
    assert same(specs, s_specs) and same(tspecs, s_tspecs)
    assert sorted(live) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(live[k], want[k], err_msg=k)


if __name__ == "__main__":
    specs, tspecs, res = jax_reference()
    res["n_processor_params"] = np.asarray(len(specs))
    print(save_reference(REF, list(specs) + list(tspecs), res))
