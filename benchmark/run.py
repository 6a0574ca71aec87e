"""Run one cell of the benchmark once on the card this machine holds:

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``harness.run``); the
numbers that decide ``correct`` are also the last lines of standard error.
Without CUDA, or with fewer cards than the cell asks for, it prints why on
standard error and exits with 2, with no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here: imports, weights, warm-up

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# every build and kernel cache of the run stays inside the checkout, at a
# fixed path, so that only a cell's first run in a checkout compiles
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, os.path.join(HERE, ".cache", sub))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))

    import torch

    from benchmark import harness

    files = harness.cell_files(args.workload)
    harness.entry_class(files["traffic"]["entry"])  # a missing driver fails here, card or none
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
