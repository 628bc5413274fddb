"""One run of one benchmark cell on the card(s) of this machine.

    python3 vcgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device, and with --trace 1 a
breakdown of the traced sub-window; each number that decided `correct`
is printed beside its limit on standard error and under "checks".

Exits non-zero and prints no result when there is no CUDA card, fewer
cards than the cell asks for, or when the process has loaded JAX or the
JAX package by the time the window has closed. --control 1 judges the
reference run one precision lower in the program's place, which has to
read not correct (used to set the limits; no benchmark run passes it).
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vcgbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    harness.setup_env()
    import torch

    if not torch.cuda.is_available():
        print("vcgbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"vcgbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    bool(args.control))


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             control: bool = False, device_name: str = "cuda",
             cache: Path = harness.CACHE) -> int:
    """Set-up, window and judgement of one cell in this process, then the
    result line; 3 and no line when the process has loaded JAX or the
    JAX package by the time the window has closed."""
    kind = importlib.import_module(f"vcgbench.kinds.{cell.traffic['kind']}")
    out = kind.run(cell, seed, seconds, trace, T0, device_name,
                   control=control, cache=cache)
    found = harness.forbidden_modules()
    if found:
        print(f"vcgbench: the run loaded {found}", file=sys.stderr)
        return 3
    return finish(cell, out, trace)


def finish(cell: harness.Cell, out: dict, trace: bool) -> int:
    """The result line from a kind's run."""
    checks = out["checks"]
    correct = bool(checks) and all(c["ok"] for c in checks) and \
        out["failed"] == 0
    dev = harness.device_record(cell.chips, out["peak"])
    if trace:
        metrics = harness.per_layer_metrics(cell, out["ctx"])
        tr = out["ctx"].get("device")
        if tr:
            dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
    else:
        metrics = {m["name"]: {"value": out[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["ctx"].get("breakdown"):
        result["breakdown"] = out["ctx"]["breakdown"]
    if out.get("readings"):
        print(f"# readings {out['readings']}", file=sys.stderr, flush=True)
    print("# run " + json.dumps({k: out[k] for k in out if isinstance(
        out[k], (int, float))}), file=sys.stderr, flush=True)
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
