"""Run one cell of the benchmark on the card and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: it loads, warms up, measures for ``--seconds``,
checks the answers against the plain reference and prints one JSON object
as the last line of standard output (the numbers compared with their limits
also as the last lines of standard error).  It exits non-zero, with no
result, where torch sees no card, fewer cards than the cell asks for, or
modules of JAX or of the JAX package once the window has closed.  Build and
kernel caches stay inside the checkout, under ``build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    import torch

    from benchmark import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry, _, _ = harness.cell_files(args.workload, spec)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: this benchmark measures the card and never runs on the CPU")
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        harness.log(f"{args.workload} needs {entry['chips']} cards; torch sees {torch.cuda.device_count()}")
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START, spec=spec)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
