"""The kinds of traffic, one module each (``kinds/<kind>.py``), found by the
``kind`` that a traffic file names. Each has ``run(cell, seed, seconds,
traced, device, t0, api) -> dict`` (one run: the result line's numbers)
and ``calibrate(cell, seeds, control, faults, device, emit)`` (the readings
that the check's limits are set from). A mix of an existing kind is a data
file alone; a new kind is a new module here, and no file changes."""
