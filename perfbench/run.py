"""The benchmark's one command.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json on the machine it is started on and
prints one JSON object as the last line of standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit, which are also
the last lines of standard error. It exits with 1 and prints no result
without enough CUDA cards or when a forbidden module (guard.py) is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Keep every kernel cache inside the checkout, at fixed paths."""
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _caches()
    sys.path.insert(0, ROOT)
    import torch

    from perfbench.catalog import find_cell
    from perfbench.harness import ForbiddenImport, run_cell

    cell = find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {cell.name} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 1
    try:
        result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    except ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
