"""One train step per new LostGAN family of the port against the JAX
package's step, on the CPU (continued from ``test_torch_port_presets_step.py``,
whose bars these are): the app-less D with the geometry-free attention
(``context_nogeo``: ``context128_nogeo`` + ``d128``), 64 px (``lostgan64`` +
``d64``, the generator's blocks named ``res2..res5``) and 256 px
(``ours_d_256``: ``ours_d_base256`` + ``d256``, stage masks from a 128-px
occupancy canvas, ch=2 to keep the JAX step small).
"""

import pytest

from layout2img_tpu_torch.train.state import TrainConfig
from test_torch_port_step_knobs import (_few_threads, check_gradients, check_losses,  # noqa: F401
                                        check_params_and_state, make_setup, run_jax, run_port)

FAMILIES = {"context_nogeo": ("context128_nogeo", "d128", 4), "lostgan64": ("lostgan64", "d64", 4),
            "ours_d_256": ("ours_d_base256", "d256", 2)}
_CACHE = {}


def step_pair(family: str):
    """(port step, JAX step) of one family, run once."""
    if family not in _CACHE:
        gen_preset, disc_preset, ch = FAMILIES[family]
        setup = make_setup(gen_preset=gen_preset, disc_preset=disc_preset, ch=ch,
                           from_port=True)
        cfg = TrainConfig(use_vgg_loss=False)
        _CACHE[family] = (run_port(setup, cfg), run_jax(setup, cfg, fast=family != "context_part"))
    return _CACHE[family]


@pytest.mark.parametrize("check", [check_losses, check_gradients, check_params_and_state])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_step_matches_jax(family, check):
    check(*step_pair(family))


def test_step_images_have_the_family_size():
    for family, size in (("lostgan64", 64), ("ours_d_256", 256)):
        port, _ = step_pair(family)
        assert port.state.generator.image_size == port.state.discriminator.image_size == size
