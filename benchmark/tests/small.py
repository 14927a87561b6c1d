"""A small cell for the CPU tests: the real configuration files at ch 8,
b 2, 4 slots and 20 classes, with the real traffic files cut to a few units."""

from __future__ import annotations

import json

from benchmark import spec

SMALL = {"ch": 8, "batch": 2, "slots": 4, "objects": [1, 3], "num_classes": 20}
SMALL_MIX = {"pool": 4, "warmup_steps": 1, "trace_units": 2, "warmup_batches": 1,
             "check_every": 2, "check_batches": 2}


def small_cell(name: str, precision: str = "f32", root=None) -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json (its metrics, traffic and limits)
    at the small sizes, computing in ``precision``."""
    cell = spec.load(name, root)
    config = {**cell.config, **SMALL, "precision": precision}
    config["train_config"] = {**config["train_config"], "mixed_precision": precision == "bf16"}
    return spec.Cell(cell.name, cell.chips, config, {**cell.traffic, **SMALL_MIX}, cell.limits,
                     cell.end_to_end, cell.per_layer)


def load_json(path):
    with open(path) as f:
        return json.load(f)
