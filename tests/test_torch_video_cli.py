"""The port's ``cli/video.py`` against the JAX package's.

* Parity: both CLIs on one frame directory and one YTVIS-style ground
  truth (``--gt``, masks at the frames' 40x60 against predictions at
  16x16, so the ground truth is resized), with the processor and the video
  predictor stubbed in both by the same seeded per-frame outputs (ids that
  appear, vanish and return): the JSON-lines files equal byte for byte (the
  RLE strings included), and the same metrics computed; ``--max-frames``
  cuts both alike. The JAX CLI then raises where it rounds the metrics
  (``round`` of HOTA's per-alpha arrays); the port prints the scalar
  metrics, each rounded as the JAX CLI rounds it.
* The port's CLI end to end on the CPU at the tiny config (``--device
  cpu``, ``--propagate``): one line a frame, each object's RLE decoding to
  a 16x16 mask, finite scores."""

import json

import numpy as np
import pytest

from sam3_lora_tpu import processor as jproc_mod
from sam3_lora_tpu import video_predictor as jvp_mod
from sam3_lora_tpu.cli import video as jcli
from sam3_lora_tpu.eval import video_eval as jeval
from sam3_lora_tpu_torch import processor as tproc_mod
from sam3_lora_tpu_torch import video_predictor as tvp_mod
from sam3_lora_tpu_torch.cli import video as tcli
from sam3_lora_tpu_torch.eval import video_eval as teval
from sam3_lora_tpu_torch.ops.rle import rle_decode, rle_encode_numpy

N_FRAMES = 6


def frame_dir(tmp_path):
    from PIL import Image

    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(N_FRAMES):
        Image.fromarray(rng.randint(0, 256, (40, 60, 3)).astype(np.uint8)).save(d / f"{i:03d}.png")
    return str(d)


def gt_file(tmp_path):
    """Two objects over the frames at 40x60 (one missing on frame 2)."""
    anns = []
    for oid, (y, x) in ((1, (5, 8)), (2, (20, 30))):
        segs = []
        for f in range(N_FRAMES):
            if oid == 2 and f == 2:
                segs.append(None)
                continue
            m = np.zeros((40, 60), np.uint8)
            m[y + f:y + f + 12, x:x + 16] = 1
            segs.append(rle_encode_numpy(m))
        anns.append({"id": oid, "segmentations": segs})
    path = tmp_path / "gt.json"
    path.write_text(json.dumps({"annotations": anns}))
    return str(path)


class StubProcessor:
    def __init__(self, *a, **k):
        self.kwargs = k


class StubPredictor:
    """Seeded outputs a frame: 16x16 masks of the ids alive then."""

    def __init__(self, proc, **kw):
        self.kw = kw

    def start_session(self, frames):
        self.n = len(frames)
        return 0

    def add_prompt(self, sid, text):
        self.prompt = text

    def propagate_in_video(self, sid):
        rng = np.random.RandomState(1)
        for f in range(self.n):
            ids = np.array([i for i in (0, 1, 3) if not (i == 1 and f in (2, 3))], np.int32)
            masks = np.zeros((len(ids), 16, 16), bool)
            for j, i in enumerate(ids):
                masks[j, 2 + 4 * j:8 + 4 * j + f % 2, 3:12] = True
            masks |= rng.rand(*masks.shape) > 0.97
            yield {"frame_idx": f, "obj_ids": ids, "masks_lowres": masks,
                   "scores": rng.rand(len(ids)).astype(np.float32)}

    def close(self):
        pass


@pytest.mark.parametrize("max_frames", [None, 4])
def test_cli_matches_jax(tmp_path, monkeypatch, capsys, max_frames):
    frames, gt = frame_dir(tmp_path), gt_file(tmp_path)
    for mod in (jproc_mod, tproc_mod):
        monkeypatch.setattr(mod, "Sam3Processor", StubProcessor)
    for mod in (jvp_mod, tvp_mod):
        monkeypatch.setattr(mod, "Sam3VideoPredictor", StubPredictor)
    computed = {"jax": {}, "port": {}}
    for name, mod in (("jax", jeval), ("port", teval)):
        for fn in ("evaluate_hota", "evaluate_clear_mot", "evaluate_track_map"):
            def spy(*a, _f=getattr(mod, fn), _d=computed[name], **k):
                out = _f(*a, **k)
                _d.update(out)
                return out

            monkeypatch.setattr(mod, fn, spy)
    extra = [] if max_frames is None else ["--max-frames", str(max_frames)]
    printed, written = [], []
    for cli, name in ((jcli, "jax"), (tcli, "port")):
        out = tmp_path / "out.jsonl"  # one path: the printed lines name it
        argv = ["--video", frames, "--prompt", "crack", "--output", str(out), "--gt", gt,
                "--propagate"] + extra + (["--device", "cpu"] if cli is tcli else [])
        if cli is jcli:
            with pytest.raises(TypeError, match="round"):
                cli.main(argv)
        else:
            assert cli.main(argv) == 0
        printed.append(capsys.readouterr().out)
        written.append(out.read_bytes())
    assert written[0] == written[1]
    assert printed[0] == printed[1].rsplit("\n", 2)[0] + "\n"  # the "wrote ..." line
    want, got = computed["jax"], computed["port"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    line = json.loads(printed[1].strip().splitlines()[-1])
    assert line == {k: round(float(v), 4) for k, v in want.items() if np.ndim(v) == 0}
    assert {"HOTA", "MOTA", "track_mAP"} <= set(line) and all(np.isfinite(v) for v in line.values())
    assert len(written[1].splitlines()) == (max_frames or N_FRAMES)


def test_cli_runs_the_port_on_the_cpu(tmp_path, capsys):
    yaml = pytest.importorskip("yaml")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({"model": {"tiny": True}}))
    out = tmp_path / "out.jsonl"
    assert tcli.main(["--video", frame_dir(tmp_path), "--prompt", "crack", "--config", str(cfg),
                      "--output", str(out), "--device", "cpu", "--propagate",
                      "--prob-threshold", "0.0", "--num-slots", "3", "--max-frames", "3"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["frame_idx"] for r in recs] == [0, 1, 2]
    assert any(r["objects"] for r in recs)
    for r in recs:
        for o in r["objects"]:
            assert rle_decode(o["segmentation"]).shape == (16, 16) and np.isfinite(o["score"])
    assert "wrote 3 frames" in capsys.readouterr().out
