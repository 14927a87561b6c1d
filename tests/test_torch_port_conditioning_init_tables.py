"""``test_torch_port_conditioning_init.py``'s checks of the flagship's table
(a file of its own, so that its JAX initialization runs on another worker):
the committed table is what the JAX script's initialization draws, and the
networks ``jax_initial_networks`` redraws from it hold those weights."""

import pytest

from layout2img_tpu_torch.scripts import train_conditioning_check as check
from test_torch_port_conditioning_init import (CONFIGS, _record, check_networks,  # noqa: F401
                                               check_tables, jax_nets)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def recorded():
    return [_record(check.parse_args(argv)) for argv in CONFIGS]


def test_tables_are_what_the_jax_script_draws(recorded):
    check_tables(recorded)


def test_port_networks_hold_the_jax_initial_weights(recorded, jax_nets):
    check_networks(recorded[0][1], CONFIGS[0], jax_nets(CONFIGS[0]))
