"""Run one cell of ``BENCHMARK.json`` once, on the CUDA devices of this machine.

    python3 -m benchmark.run --workload coco128.train_b256 --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and last
``check``: each number the correctness check compared, beside its limit.
Standard error ends with the same numbers, one line each.

Without a CUDA device, or with fewer than the cell asks for, it exits with
code 2 and prints no result: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

from benchmark import T0, log

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "layout2img_tpu")
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def cache_dirs() -> None:
    """Every kernel cache inside the checkout, at fixed paths."""
    cache = HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that belong to JAX or the JAX package."""
    return sorted({n.split(".", 1)[0] for n in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unreadable: {e}"


def run_cell(cell, seed: int, seconds: float, traced: bool, device, api=None) -> dict:
    """One run of ``cell`` on ``device`` (tests pass the CPU and a small
    configuration): the result line's dict, without ``device``."""
    import torch

    from benchmark import check, spec
    from benchmark import program as program_api

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = spec.kind(cell.traffic["kind"]).run(cell, seed, seconds, traced, device, T0,
                                              api=api or program_api)
    correct, lines = check.judge(out["numbers"], cell.limits)
    correct = correct and out["finite"] and out["failed"] == 0
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {k: v if isinstance(v, dict) else {"value": v, "unit": _unit(cell, k)}
                          for k, v in out["metrics"].items()},
              "peak": out["peak"], "lines": lines,
              "check": {k: {"value": _plain(v), "limit": cell.limits.get(k)}
                        for k, v in check.judged(out["numbers"], cell.limits).items()}}
    for k in ("busy_s", "window_s", "breakdown", "forbidden", "kind"):
        if k in out:
            result[k] = out[k]
    return result


def _plain(v: float) -> float | str:
    """A JSON number, or "inf" / "nan" as text."""
    return v if math.isfinite(v) else str(v)


def _unit(cell, name: str) -> str:
    return next(m["unit"] for m in cell.end_to_end + cell.per_layer if m["name"] == name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once on the CUDA devices.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    from benchmark import spec

    cell = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: no CUDA device for {args.workload}: it needs {cell.chips}, found "
              f"{found}; the benchmark does not run on the CPU", file=sys.stderr)
        return 2
    try:
        import layout2img_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program layout2img_tpu_torch is not importable here: {e}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    # read after the window, so that nvidia-smi's own time is not set-up
    log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    found = sorted(set(forbidden_modules()) | set(result.get("forbidden", ())))
    if found:
        print(f"benchmark: the run loaded {found}: the port may not load JAX or the JAX "
              f"package", file=sys.stderr)
        return 4
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": {"platform": "gpu",
                       "kind": result.get("kind") or torch.cuda.get_device_name(0),
                       "count": cell.chips, "memory_peak_bytes": result["peak"]}}
    if args.trace:
        line["device"]["busy_s"] = result["busy_s"]
        line["device"]["window_s"] = result["window_s"]
        if "breakdown" in result:
            line["breakdown"] = result["breakdown"]
    line["check"] = result["check"]
    for text in result["lines"]:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
