"""The port's ``io_utils.py`` (a copy) and ``video_predictor.py`` (a near
copy) against the JAX package's.

* The copies: ``io_utils.py`` and ``video_predictor.py`` have the JAX
  files' code, statement for statement (their syntax trees equal once the
  docstrings are dropped; ``video_predictor.py`` imports the port's
  modules by the same relative names).
* ``io_utils``: both packages' ``VideoFrameSource`` over a list, one
  array, a directory of PNG frames and an mp4 (OpenCV), random access out
  of order, ``load_video_frames`` and ``AsyncVideoFrameLoader`` (order,
  length, ``max_frames``, an error raised on the consumer's side): equal
  frames, bit for bit.
* ``Sam3VideoPredictor`` on the port's tiny processor (CPU) with the
  weights of ``test_torch_video.py``: a session's outputs are the stored
  JAX ``VideoGrounder`` run's (the predictor is a loop over it), without
  and with memory propagation; two sessions interleaved, each equal to
  that run; the lifecycle (prompt first, cursor, start and max frames,
  ``get_output``, unknown and closed sessions)."""

import threading

import numpy as np
import pytest

from sam3_lora_tpu import io_utils as jio
from sam3_lora_tpu import video_predictor as jvp
from sam3_lora_tpu_torch import io_utils as tio
from sam3_lora_tpu_torch import video_predictor as tvp

import test_torch_video as tv
from torch_port_helpers import code_of, fill_params, nested, port_tiny_processor


@pytest.mark.parametrize("pair", [(jio, tio), (jvp, tvp)], ids=["io_utils", "video_predictor"])
def test_copy_has_the_jax_code(pair):
    assert code_of(pair[0]) == code_of(pair[1])


def make_frames(n=5, h=24, w=32, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(n)]


def _sources(tmp_path):
    from PIL import Image
    import cv2

    frames = make_frames(4)
    (tmp_path / "dir").mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / "dir" / f"{i:04d}.png")
    (tmp_path / "dir" / "notes.txt").write_text("not a frame")
    path = str(tmp_path / "v.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    for c in ((200, 30, 30), (30, 200, 30), (30, 30, 200)):
        for _ in range(2):
            vw.write(np.full((32, 32, 3), c, np.uint8))
    vw.release()
    return {"list": frames, "array": frames[0], "dir": str(tmp_path / "dir"), "mp4": path}


def test_frame_sources_equal_jax(tmp_path):
    for name, src in _sources(tmp_path).items():
        a, b = jio.VideoFrameSource(src), tio.VideoFrameSource(src)
        assert len(a) == len(b), name
        for i in list(range(len(a)))[::-1] + list(range(len(a))):  # out of order, then in
            np.testing.assert_array_equal(b.get(i), a.get(i), err_msg=f"{name} {i}")
        a.close()
        b.close()
        for x, y in zip(jio.load_video_frames(src, max_frames=3),
                        tio.load_video_frames(src, max_frames=3)):
            np.testing.assert_array_equal(y, x)
    with pytest.raises(FileNotFoundError):
        (tmp_path / "empty").mkdir()
        tio.VideoFrameSource(str(tmp_path / "empty"))


@pytest.mark.parametrize("max_frames", [None, 3])
def test_async_loader_equals_jax(max_frames):
    frames = make_frames(7)
    a = jio.AsyncVideoFrameLoader(frames, prefetch=2, max_frames=max_frames)
    b = tio.AsyncVideoFrameLoader(frames, prefetch=2, max_frames=max_frames)
    got, want = list(b), list(a)
    assert len(got) == len(b) == len(want) == len(a)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_async_loader_raises_on_the_consumer_side(tmp_path):
    """A frame that fails to decode in the loader's thread raises where
    the consumer reads it, after the frames before it."""
    from PIL import Image

    for i, f in enumerate(make_frames(4)):
        Image.fromarray(f).save(tmp_path / f"{i:04d}.png")
    (tmp_path / "0002.png").write_bytes(b"not a png")
    loader = tio.AsyncVideoFrameLoader(str(tmp_path), prefetch=1)
    seen = []
    with pytest.raises(OSError):
        for f in loader:
            seen.append(f)
    assert len(seen) == 2
    loader._thread.join(timeout=10)
    assert not loader._thread.is_alive()


# ---------------------------------------------------------------------------
# sessions, against the stored JAX grounder runs of test_torch_video.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    return tv._load()


def predictor(ref, run):
    specs, tspecs, _ = ref
    kw, _ = tv.RUNS[run]
    kw = dict(kw, num_maskmem=tv.NM, max_obj_ptrs=tv.NP)
    prop = kw.pop("propagate", False)
    if prop:
        kw["tracker_params"] = nested(fill_params(tspecs, seed=1))
    return tvp.Sam3VideoPredictor(port_tiny_processor(specs), propagate_memory=prop, **kw)


def check_outputs(outs, want, run, first=0):
    for o in outs:
        i = o["frame_idx"]
        np.testing.assert_array_equal(o["obj_ids"], want[f"{run}/{i}/out/obj_ids"])
        np.testing.assert_allclose(o["scores"], want[f"{run}/{i}/out/scores"], rtol=tv.RUN_TOL,
                                   atol=tv.RUN_TOL)
        np.testing.assert_array_equal(o["masks_lowres"], want[f"{run}/{i}/out/masks_lowres"])
    assert [o["frame_idx"] for o in outs] == list(range(first, first + len(outs)))


@pytest.mark.parametrize("run", ["noprop", "prop"])
def test_session_outputs_equal_the_jax_grounder(ref, run):
    vp = predictor(ref, run)
    sid = vp.start_session(tv.FRAMES)
    vp.add_prompt(sid, tv.PROMPT)
    outs = list(vp.propagate_in_video(sid, max_frames=6))
    check_outputs(outs, ref[2], run)
    assert vp.get_output(sid, 3) is outs[3]
    vp.close()


def test_interleaved_sessions_are_independent(ref):
    vp = predictor(ref, "noprop")
    a, b = vp.start_session(tv.FRAMES[:6]), vp.start_session(list(tv.FRAMES[:6]))
    vp.add_prompt(a, tv.PROMPT)
    vp.add_prompt(b, tv.PROMPT)
    out_a = list(vp.propagate_in_video(a, max_frames=2))   # a runs ahead by two frames
    for oa, ob in zip(vp.propagate_in_video(a), vp.propagate_in_video(b)):
        out_a.append(oa)
        check_outputs([ob], ref[2], "noprop", first=ob["frame_idx"])
    check_outputs(out_a, ref[2], "noprop")
    vp.close()


def test_session_lifecycle(ref):
    vp = predictor(ref, "noprop")
    sid = vp.start_session(tv.FRAMES[:4])
    with pytest.raises(RuntimeError, match="add_prompt"):
        next(vp.propagate_in_video(sid))
    vp.add_prompt(sid, tv.PROMPT)
    assert [o["frame_idx"] for o in vp.propagate_in_video(sid, max_frames=2)] == [0, 1]
    assert [o["frame_idx"] for o in vp.propagate_in_video(sid)] == [2, 3]   # from the cursor
    assert [o["frame_idx"] for o in vp.propagate_in_video(sid, start_frame=1,
                                                          max_frames=1)] == [1]
    vp.add_prompt(sid, "something else")  # resets the outputs and the cursor
    assert vp._get(sid).frame_outputs == {} and vp._get(sid).cursor == 0
    vp.close_session(sid)
    with pytest.raises(KeyError, match="unknown session"):
        vp.add_prompt(sid, tv.PROMPT)
    assert isinstance(vp._lock, type(threading.Lock()))
