"""The program's entry points, driven as a user drives them. A traffic file
names its entry (``"entry"``: a key of ``ENTRIES``, or a driver file of
``benchmark/drivers/``, as ``Entry`` says); each class builds the program
from the configuration and the seed, warms up every shape the traffic uses,
runs the measured window, frees the program, and then works out the
reference's answers to what the window's own path produced.

* ``Train``: ``Trainer.setup`` and ``Trainer.train_step`` on batches of the
  port's input path (``COCOSegmentDataset`` -> ``DataLoader`` ->
  ``prefetch_to_device``, as ``cli/train.py`` builds them) over a COCO split
  that set-up writes, in a process whose tensor ops on the host use one
  intra-op thread. Set-up runs the first ``check_steps`` updates through
  the same call and feed, and keeps what the check needs.
* ``Predict``: a closed loop of one caller on ``SAM3LoRAInference.predict``
  over a cycle of requests, each with a threshold of its own.
* ``Processor``: a closed loop of one caller on ``Sam3Processor``: each
  session ``set_image`` and ``prompts_per_session`` ``set_text_prompt``
  calls; a prompt is a request, and the first one's time holds
  ``set_image``.

The benchmark's weights reach the program through ``init_model``, the one
function that fills a built model's parameters in the program's set-up: it
is replaced, for the duration of the build, by one that copies the
benchmark's (``weights.py``) and counts its calls.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from . import compare, data, weights
from .configs_io import port_configs, ref_configs
from .trace import span

def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def weight_spec(config: Dict):
    from .reference import model as ref_model

    mcfg, lcfg = ref_configs(config)
    return weights.leaves(ref_model.build(mcfg, lcfg, "meta"))


@contextlib.contextmanager
def benchmark_weights(config: Dict, seed: int, device):
    """Inside the block, the program's set-up fills its model with the
    benchmark's weights for ``seed``, in the configuration's storage type."""
    import sam3_lora_tpu_torch.inference as inference_mod
    import sam3_lora_tpu_torch.train.trainer as trainer_mod

    spec = weight_spec(config)
    dtype = getattr(torch, config["model"]["param_dtype"])
    calls = []

    def init_model(model, generator=None):
        w = weights.make(spec, seed, dtype, device)
        weights.load_into(model, w)
        del w
        calls.append(1)
        return model

    saved = (trainer_mod.init_model, inference_mod.init_model)
    trainer_mod.init_model = inference_mod.init_model = init_model
    try:
        yield
    finally:
        trainer_mod.init_model, inference_mod.init_model = saved
    if len(calls) != 1:
        raise RuntimeError(f"the program's set-up filled {len(calls)} models, not one")


def reference_model(config: Dict, seed: int, device, lower: bool = False):
    """The reference model with the benchmark's weights for ``seed``
    (``lower``: the control's, with the configuration's compute type)."""
    from .reference import model as ref_model

    mcfg, lcfg = ref_configs(config)
    model = ref_model.build(mcfg, lcfg, device, dtype=mcfg.dtype if lower else "float32")
    w = weights.make(weight_spec(config), seed, getattr(torch, config["model"]["param_dtype"]),
                     device)
    weights.load_into(model, w, derived=())
    return model


class Entry:
    """What every entry shares: the run's inputs and its tallies; and the
    contract by which ``harness.run`` drives one, built as
    ``cls(config, traffic, seed, device, workdir)`` from the cell's files.

    * ``unit``: what the window counts, one per span the driver opens round
      it with ``trace.span`` (``program.UNIT_SPAN`` names the span of the
      three entries here; any other unit's span is named as the unit, so a
      ``frame`` driver opens ``span("frame")``). The per-layer readers
      divide by these spans.
    * ``attempted``, ``failed``: the units the window started and those
      that failed (``harness.run`` reads them after the window).
    * ``setup()``: build the program and warm up every shape the traffic
      uses (set-up: ``setup_s`` counts it); nothing may compile after it.
    * ``window(seconds)``: drive the program for ``seconds``.
    * ``e2e(window_s)``: the cell's end-to-end metrics by their names in
      ``BENCHMARK.json``, over the whole window; ``peak_gib`` and
      ``setup_s`` are the harness's own.
    * ``close()``: free the program (the peak has been read).
    * ``check()``: the reference's readings of what the window produced,
      one for every key of the cell's ``limits`` file.
    * ``work()``: ``{flops, attn, int8}`` of the units the window
      completed, for the traced readers (``ctx["work"]``).
    * ``waits`` (optional): host seconds each unit waited for its input
      (``ctx["data_wait_s"]``).

    A new driver is a new file ``benchmark/drivers/<entry>.py`` whose
    ``ENTRY`` subclasses this class (``harness.entry_class``). It may import
    ``benchmark.reference`` and new files beside it, and must not import
    JAX or the JAX package: a run that loaded them prints no result
    (``harness.forbidden_modules``).
    """

    unit = ""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, workdir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.workdir = workdir
        self.attempted = self.failed = 0
        self.latencies: List[float] = []
        self.failed_starts: List[float] = []

    def work(self) -> Dict:
        """{flops, attn, int8} of the units the window completed."""
        raise NotImplementedError


class Train(Entry):
    unit = "train"
    # The process's host-side tensor ops run on one intra-op thread, as
    # ``torchrun`` launches a training job (OMP_NUM_THREADS=1): the step is
    # held by the host's launches, and a full pool of intra-op threads beside
    # the launching thread made it slower, the more so the busier the host's
    # shared cores were.
    host_threads = 1

    def setup(self):
        from sam3_lora_tpu_torch.config import TrainConfig
        from sam3_lora_tpu_torch.train.data import COCOSegmentDataset, DataLoader
        from sam3_lora_tpu_torch.train.prefetch import prefetch_to_device
        from sam3_lora_tpu_torch.train.trainer import Trainer

        self.saved_threads = torch.get_num_threads()
        torch.set_num_threads(self.host_threads)

        mcfg, lcfg = port_configs(self.config)
        t = self.traffic
        self.tseed = weights.sub_seed(self.seed, "train", bits=31)
        tcfg = TrainConfig(**self.config["train"], batch_size=t["batch_size"], seed=self.tseed,
                           output_dir=os.path.join(self.workdir, "out"))
        self.tcfg = tcfg
        self.root = data.write_coco(os.path.join(self.workdir, "data"), self.seed, t)
        with benchmark_weights(self.config, self.seed, self.device):
            self.trainer = Trainer(mcfg, lcfg, tcfg, device=self.device)
            ds = COCOSegmentDataset(self.root, "train", model_config=mcfg,
                                    per_category_queries=tcfg.per_category_queries,
                                    include_negatives=tcfg.include_negatives)
            self.loader = DataLoader(ds, tcfg.batch_size, num_workers=tcfg.num_workers,
                                     seed=tcfg.seed)
            self.trainer.setup(steps_per_epoch=len(self.loader))

        def stream():
            epoch = 0
            while True:
                it = self.loader.epoch(epoch)
                if tcfg.device_prefetch > 0:
                    it = prefetch_to_device(it, self.device, tcfg.device_prefetch)
                yield from it
                epoch += 1

        self.stream = stream()
        tr = self.trainer
        names = tr.trainable_names
        p0 = {n: p.detach().float().cpu().clone() for n, p in zip(names, tr.trainable)}
        self.prog = {"losses": [], "presence": []}
        for step in range(t["check_steps"]):
            losses = tr.train_step(next(self.stream))
            self.prog["losses"].append(float(losses["core_loss"]))
            self.prog["presence"].append(compare.presence_terms(losses))
            if step == 0:  # AdamW's first moment is (1 - beta1) g: no state, no gradient
                b1 = tcfg.adam_beta1
                self.prog["grad"] = {
                    n: (tr.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p)).float()
                        / (1 - b1)).cpu()
                    for n, p in zip(names, tr.trainable)}
        self.prog["update"] = {n: p.detach().float().cpu() - p0[n]
                               for n, p in zip(names, tr.trainable)}
        _sync(self.device)

    def window(self, seconds: float):
        tr, b = self.trainer, self.traffic["batch_size"]
        self.waits: List[float] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.attempted += 1
            tw = time.perf_counter()
            with span("data_wait"):
                batch = next(self.stream)
            self.waits.append(time.perf_counter() - tw)
            with span("train_step"):
                tr.train_step(batch)
        self.units = self.attempted
        self.images = self.attempted * b

    def close(self):
        self.stream.close()
        del self.trainer, self.stream, self.loader
        _free(self.device)
        torch.set_num_threads(self.saved_threads)

    def e2e(self, window_s: float) -> Dict[str, float]:
        return {"train_images_per_s": self.images / window_s}

    def work(self) -> Dict:
        from .work import unit_work

        w = unit_work(self.config, "train", self.traffic["batch_size"])
        return {k: (v * self.units if k == "flops" else tuple(x * self.units for x in v))
                for k, v in w.items()}

    def check(self) -> Dict[str, float]:
        self.ref = self.reference(lower=False)
        return compare.train_readings(self.prog, self.ref)

    def control(self) -> Dict[str, float]:
        """The control's readings (after ``check``): the reference one
        precision down in the program's place; ``match_flips``, the
        assignments the two solved differently."""
        ctl = self.reference(lower=True)
        out = compare.train_readings(ctl, self.ref)
        out["match_flips"] = float(sum(int((a != b).sum()) for a, b in
                                       zip(ctl["matches"], self.ref["matches"])))
        return out

    def reference(self, lower: bool) -> Dict:
        """The reference's first ``check_steps`` updates on the same images,
        from the same weights (``lower``: the control, one precision down)."""
        from .reference import model as ref_model
        from .reference import numerics, sam3_image
        from .reference.pipeline import loader_order, train_batch, train_steps

        t, b = self.traffic, self.traffic["batch_size"]
        model = reference_model(self.config, self.seed, self.device, lower)
        named = ref_model.trainable(model)
        p0 = {n: p.detach().clone() for n, p in named}
        n_img = t["images"]
        order = loader_order(n_img, self.tseed, 0)
        split = os.path.join(self.root, "train")
        batches = [train_batch(split, order[i * b:(i + 1) * b], model.spec.model, self.device)
                   for i in range(t["check_steps"])]
        numerics.NUM.fp8, numerics.NUM.int_bits = lower, (4 if lower else 8)
        sam3_image.MATCH_LOG = matches = []
        try:
            losses, presence, first = train_steps(model, named, batches, self.config["train"],
                                                  self.tseed, steps_per_epoch=n_img // b)
        finally:
            numerics.NUM.fp8, numerics.NUM.int_bits = False, 8
            sam3_image.MATCH_LOG = None
        out = {"losses": losses, "presence": presence,
               "grad": {n: g.float().cpu() for n, g in first.items()},
               "update": {n: (p.detach() - p0[n]).float().cpu() for n, p in named},
               "matches": matches}
        del model, named, batches
        _free(self.device)
        return out


class Serve(Entry):
    """What ``Predict`` and ``Processor`` share: the pool, the threshold, the
    latencies and the check of a sample of answers."""

    def calibrate(self, all_scores: List[np.ndarray]) -> float:
        """The threshold that keeps ``detections_per_prompt`` answers a prompt
        on average over the calibration prompts (every query's score of
        each): the k-th highest of their pooled scores, k that many times
        the prompts. The answers, and the host's work on them, then come to
        the same count in every seed."""
        scores = np.sort(np.concatenate(all_scores))
        k = min(self.traffic["detections_per_prompt"] * len(all_scores), len(scores))
        return float(scores[-k]) - 1e-6

    def e2e(self, window_s: float) -> Dict[str, float]:
        # a failed request counts as one that ends with the window
        lat = sorted(self.latencies + [self.t_end - t for t in self.failed_starts])
        p90 = statistics.quantiles(lat, n=10)[-1] if len(lat) >= 2 else float("inf")
        return {"serve_requests_per_s": (self.attempted - self.failed) / window_s,
                "serve_request_p90_ms": p90 * 1e3}

    def check_prompts(self, model, items, lower: bool):
        """[(program answers, reference answers, hw, threshold)] of the
        sampled prompts; ``items``: [(pool index, prompts, answers or None,
        threshold)]."""
        from .reference import numerics
        from .reference.pipeline import answers, detect

        out = []
        numerics.NUM.fp8, numerics.NUM.int_bits = lower, (4 if lower else 8)
        try:
            for img_idx, prompts, got, thr in items:
                image = self.pool[img_idx]
                hw = image.shape[:2]
                s, pres, boxes, masks = detect(model, image, prompts, self.device)
                for i in range(len(prompts)):
                    ref = answers(s[i], pres[i], boxes[i], masks[i], hw, thr, self.kind,
                                  margin=compare.SURE)
                    out.append((got[i] if got is not None else ref, ref, hw, thr))
        finally:
            numerics.NUM.fp8, numerics.NUM.int_bits = False, 8
        return out

    def sample(self) -> List[int]:
        """The requests (sessions) whose answers are checked: among the
        window's first ``check_among_first``, those that returned answers,
        drawn from the seed (``check_requests`` or ``check_sessions`` of
        them), with the one of the most prompts; the prompts without answers
        of a chosen request are checked too (the reference must keep none)."""
        k = self.traffic.get("check_requests", self.traffic.get("check_sessions"))
        answered = [i for i in sorted(self.kept)
                    if any(r["scores"] is not None and len(r["scores"]) for r in self.kept[i])]
        return data.check_sample(self.seed, [(i, self.kept[i]) for i in answered], k,
                                 len(answered), key=lambda j: answered[j])

    def readings(self, pairs) -> Dict[str, float]:
        return compare.merge([compare.match_answers(p, r, thr, hw) for p, r, hw, thr in pairs])


class Predict(Serve):
    """The window repeats one cycle of requests (``data.requests``), and each
    request keeps its own threshold: the one that leaves it
    ``detections_per_prompt`` answers a prompt, pooled over its prompts.
    The answers, and the host's work of resizing and copying their masks,
    then come to the same count in every seed, request by request."""

    unit = "request"
    kind = "predict"

    def setup(self):
        from sam3_lora_tpu_torch.inference import SAM3LoRAInference

        mcfg, lcfg = port_configs(self.config)
        t = self.traffic
        self.pool = data.image_pool(self.seed, t)
        with benchmark_weights(self.config, self.seed, self.device):
            self.engine = SAM3LoRAInference(mcfg, lcfg, device=self.device)
        self.requests = data.requests(self.seed, t)
        # each request's threshold from every query's score of its prompts
        self.thresholds = []
        for img, prompts in self.requests:
            res = self.engine.predict(self.pool[img], prompts, threshold=0.0, resize_masks=False)
            self.thresholds.append(self.calibrate([r["scores"] for r in res.values()]))
        # every (size, prompt count) the traffic sends, once
        seen = set()
        for (img, prompts), thr in zip(self.requests, self.thresholds):
            key = (self.pool[img].shape, len(prompts))
            if key not in seen:
                seen.add(key)
                self.engine.predict(self.pool[img], prompts, threshold=thr,
                                    resize_masks=t["resize_masks"])
        _sync(self.device)

    def window(self, seconds: float):
        self.kept = {}
        self.done_prompts = []
        t = self.traffic
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            img, prompts = self.requests[i % len(self.requests)]
            thr = self.thresholds[i % len(self.requests)]
            self.attempted += 1
            ts = time.perf_counter()
            try:
                with span("request"):
                    res = self.engine.predict(self.pool[img], prompts, threshold=thr,
                                              resize_masks=t["resize_masks"])
                self.latencies.append(time.perf_counter() - ts)
                self.done_prompts.append(len(prompts))
                if i < t["check_among_first"]:
                    self.kept[i] = [res[q] for q in range(len(prompts))]
            except Exception:  # noqa: BLE001 - a failed request is counted, not raised
                self.failed += 1
                self.failed_starts.append(ts)
            i += 1
        self.t_end = time.perf_counter()
        self.units = len(self.done_prompts)

    def close(self):
        del self.engine
        _free(self.device)

    def work(self) -> Dict:
        from .work import unit_work

        tot = {"flops": 0.0, "attn": (0.0, 0.0, 0.0), "int8": (0.0, 0.0, 0.0)}
        for n in self.done_prompts:
            w = unit_work(self.config, "request", n)
            tot = {k: (tot[k] + w[k] if k == "flops" else tuple(a + b for a, b in zip(tot[k], w[k])))
                   for k in tot}
        return tot

    def items(self):
        n = len(self.requests)
        return [(*self.requests[i % n], self.kept[i], self.thresholds[i % n])
                for i in self.sample()]

    def check(self) -> Dict[str, float]:
        model = reference_model(self.config, self.seed, self.device)
        pairs = self.check_prompts(model, self.items(), lower=False)
        del model
        _free(self.device)
        return self.readings(pairs)

    def control(self) -> Dict[str, float]:
        """The control's readings: the reference one precision down in the
        program's place, on the same sampled requests."""
        items = [(a, b, None, thr) for a, b, _, thr in self.items()]
        pairs = []
        for lower in (False, True):
            model = reference_model(self.config, self.seed, self.device, lower)
            pairs.append(self.check_prompts(model, items, lower=lower))
            del model
            _free(self.device)
        ref, ctl = pairs
        return self.readings([(c[1], r[1], r[2], r[3]) for c, r in zip(ctl, ref)])


class Processor(Serve):
    unit = "prompt"
    kind = "processor"

    def setup(self):
        from sam3_lora_tpu_torch.processor import Sam3Processor

        mcfg, lcfg = port_configs(self.config)
        t = self.traffic
        self.pool = data.image_pool(self.seed, t)
        with benchmark_weights(self.config, self.seed, self.device):
            self.proc = Sam3Processor(mcfg, lcfg, device=self.device)
        self.sessions = data.sessions(self.seed, t, t.get("max_sessions", 4000))
        # the threshold from every query's score of the first sessions' prompts
        scores = []
        for img, prompts in self.sessions[:t["calibrate"]]:
            self.proc.set_image(self.pool[img])
            for p in prompts:
                scores.append(np.asarray(self.proc.set_text_prompt(p, threshold=0.0)["scores"]))
        self.threshold = self.calibrate(scores)
        seen = set()  # every image size once, with the threshold
        for img, prompts in self.sessions[:200]:
            if self.pool[img].shape not in seen:
                seen.add(self.pool[img].shape)
                self.proc.set_image(self.pool[img])
                for p in prompts:
                    self.proc.set_text_prompt(p, threshold=self.threshold)
        _sync(self.device)

    def window(self, seconds: float):
        self.kept = {}
        self.images = self.prompts = 0
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            img, prompts = self.sessions[i % len(self.sessions)]
            got = []
            ts = time.perf_counter()
            try:
                with span("set_image"):
                    self.proc.set_image(self.pool[img])
                self.images += 1
            except Exception:  # noqa: BLE001
                self.attempted += len(prompts)
                self.failed += len(prompts)
                self.failed_starts += [ts] * len(prompts)
                i += 1
                continue
            for p in prompts:
                self.attempted += 1
                try:
                    with span("prompt"):
                        got.append(self.proc.set_text_prompt(p, threshold=self.threshold))
                    self.latencies.append(time.perf_counter() - ts)
                    self.prompts += 1
                except Exception:  # noqa: BLE001
                    self.failed += 1
                    self.failed_starts.append(ts)
                ts = time.perf_counter()
                if time.perf_counter() - t0 >= seconds:
                    break
            if i < self.traffic["check_among_first"] and len(got) == len(prompts):
                self.kept[i] = [{"scores": g["scores"], "boxes": g["boxes"],
                                 "masks": g["masks_lowres"]} for g in got]
            i += 1
        self.t_end = time.perf_counter()
        self.units = self.prompts

    def close(self):
        del self.proc
        _free(self.device)

    def work(self) -> Dict:
        from .work import unit_work

        a, b = unit_work(self.config, "image"), unit_work(self.config, "prompt")
        return {k: (a[k] * self.images + b[k] * self.prompts if k == "flops" else
                    tuple(x * self.images + y * self.prompts for x, y in zip(a[k], b[k])))
                for k in a}

    def items(self):
        return [(*self.sessions[i], self.kept[i], self.threshold) for i in self.sample()]

    check = Predict.check
    control = Predict.control


ENTRIES = {"train": Train, "predict": Predict, "processor": Processor}


def make_workdir() -> str:
    """A scratch directory for this run's data, under ``TMPDIR``."""
    return tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))


def remove_workdir(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)
