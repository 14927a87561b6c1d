"""The readings that a cell's check limits are set from, in one process on
the card, at the cell's own sizes (no measured window):

- ``program``: the program against the f32 reference, on every seed given;
- ``control``: the reference computed with fp8 operands (the precision one
  step below the configuration's bf16) in the program's place;
- faults planted in the reference put in the program's place: train cells
  ``half_batch`` (half of the batch left out, the means over the rest);
  data-parallel cells also ``no_exchange`` (the gradients not summed over
  the ranks); sample cells ``altered`` (one image of each batch answered
  with another request's image) and ``half_batch`` (half of each batch's
  images never produced: zeros). A state left unchanged reads
  ``update_gap`` 1 by the check's definition and needs no run.

Each kind's ``calibrate`` (``kinds/<kind>.py``) makes its readings.

    python3 -m benchmark.calibrate --workload coco128.train_b256 --seeds 1,2,3 \\
        --control 1,2,3 --faults 1,2,3 --out cal.jsonl

One JSON line per seed and side, on standard output and in ``--out``; the
lines in ``--out`` of train cells also hold each side's readings in full
(``detail``: losses per step, each parameter's first gradient and change).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import spec
from benchmark.run import cache_dirs, card_line


def _ints(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for a cell's check limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated: the program's seeds")
    ap.add_argument("--control", default="", help="seeds that also read the fp8 control")
    ap.add_argument("--faults", default="", help="seeds that also read the planted faults")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cache_dirs()
    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    control, faults = set(_ints(args.control)), set(_ints(args.faults))
    out = open(args.out, "a") if args.out else None

    def emit(seed: int, side: str, numbers: dict, extra: dict) -> None:
        row = {"workload": args.workload, "seed": seed, "side": side, **numbers, **extra}
        print(json.dumps({k: v for k, v in row.items() if k != "detail"}), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    try:
        spec.kind(cell.traffic["kind"]).calibrate(cell, _ints(args.seeds), control, faults,
                                                  device, emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
