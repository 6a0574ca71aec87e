"""The readings that a cell's limits are set from, many seeds in one process
(the benchmark's own runs never run this):

    python -m benchmark.control --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault half_batch] [--seconds 12]

For each seed, one JSON line: the program's readings (set-up, for serving
cells a short window at the cell's load, then the check against the
reference, exactly as a run makes them) and, for the seeds in
``--control-seeds``, the control's: the reference computed one precision
below the configuration's (float8 e4m3 operands for bf16 products, int4 for
int8; ``reference/numerics.py``) in the program's place, against the
reference. ``--fault half_batch`` plants a fault in the program instead:
each update steps on the first half of its batch, the loss the mean over
those rows.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


@contextlib.contextmanager
def fault(name):
    if not name:
        yield
        return
    if name != "half_batch":
        raise ValueError(f"unknown fault {name!r}")
    from sam3_lora_tpu_torch.train import trainer as trainer_mod

    real = trainer_mod.Trainer.train_step

    def half(self, batch):
        return real(self, trainer_mod.split_microbatches(batch, 2)[0])

    trainer_mod.Trainer.train_step = half
    try:
        yield
    finally:
        trainer_mod.Trainer.train_step = real


def readings(files, seed: int, device, control: bool, fault_name: str = "",
             seconds: float = 12.0):
    """One seed's readings of the program (and of the control)."""
    from benchmark.entries import ENTRIES, make_workdir, remove_workdir

    workdir = make_workdir()
    try:
        entry = ENTRIES[files["traffic"]["entry"]](files["config"], files["traffic"], seed,
                                                    device, workdir)
        with fault(fault_name):
            entry.setup()
            if entry.unit != "train":
                entry.window(seconds)
        entry.close()
        out = {"program": entry.check()}
        if control:
            out["control"] = entry.control()
        return out
    finally:
        remove_workdir(workdir)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="readings of the program and the control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--seconds", type=float, default=12.0)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    files = harness.cell_files(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                **readings(files, seed, "cuda", seed in controls, args.fault, args.seconds),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
