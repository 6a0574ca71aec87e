"""The timed path broken underneath, and the rest of a run as it is: the
cell's own limits must read ``correct`` false. Faults: an update that
leaves the adapters unchanged; half of each batch left out, the loss the
mean over the rest; an answer altered where it is produced. (No cell spans
chips, so none has an exchange to leave out.) The control, the reference
one precision down in the program's place, must fail them too."""

import pytest

from benchmark import control, harness
from benchmark.tests.tiny import tiny

SEED = 2**31 + 99


def run(workload):
    return harness.run(workload, SEED, 1.0, False, device="cpu", alter=tiny)


@pytest.mark.parametrize("workload", ["train-int8-b8", "train-bf16-b4"])
def test_unchanged_state(workload, monkeypatch):
    from sam3_lora_tpu_torch.train import trainer

    def no_update(optimizer, params, lr, max_grad_norm):
        optimizer.zero_grad(set_to_none=True)

    monkeypatch.setattr(trainer, "apply_update", no_update)
    r = run(workload)
    assert not r["correct"] and r["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["train-int8-b8", "train-bf16-b4"])
def test_half_batch(workload):
    with control.fault("half_batch"):
        r = run(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["serve-int8-1to3", "prompts-bf16-8"])
def test_altered_answer(workload, monkeypatch):
    from sam3_lora_tpu_torch.inference import SAM3LoRAInference
    from sam3_lora_tpu_torch.processor import Sam3Processor

    if workload.startswith("serve"):
        real = SAM3LoRAInference.predict

        def predict(self, *a, **kw):
            out = real(self, *a, **kw)
            for r in out.values():
                if r["num_detections"]:
                    r["boxes"] = r["boxes"] * 1.25
            return out
        monkeypatch.setattr(SAM3LoRAInference, "predict", predict)
    else:
        real = Sam3Processor.set_text_prompt

        def prompt(self, *a, **kw):
            out = real(self, *a, **kw)
            out["masks_lowres"] = ~out["masks_lowres"]
            return out
        monkeypatch.setattr(Sam3Processor, "set_text_prompt", prompt)
    r = run(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["train-int8-b8", "serve-int8-1to3"])
def test_control_fails(workload):
    files = tiny(harness.cell_files(workload))
    got = control.readings(files, SEED, "cpu", True, seconds=1.0)
    from benchmark.compare import judge

    assert judge(got["program"], files["limits"])
    assert not judge(got["control"], files["limits"])
