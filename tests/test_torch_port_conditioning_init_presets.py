"""``test_torch_port_conditioning_init.py``'s checks for the other LostGAN
rows of the JAX README's conditioning table: ``graph128`` and
``context128_part``, each with ``--no_app_head`` (a file of its own, so that
the JAX initializations run on another worker)."""

import pytest

from layout2img_tpu_torch.scripts import train_conditioning_check as check
from test_torch_port_conditioning_init import (TABLE_CONFIGS, _record, check_networks,  # noqa: F401
                                               check_tables, jax_nets)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

CONFIGS = TABLE_CONFIGS[1:]


@pytest.fixture(scope="module")
def recorded():
    return [_record(check.parse_args(argv)) for argv in CONFIGS]


def test_tables_are_what_the_jax_script_draws(recorded):
    check_tables(recorded)


@pytest.mark.parametrize("config", range(len(CONFIGS)))
def test_port_networks_hold_the_jax_initial_weights(recorded, config, jax_nets):
    check_networks(recorded[config][1], CONFIGS[config], jax_nets(CONFIGS[config]))
