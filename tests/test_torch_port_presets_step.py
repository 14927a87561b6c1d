"""One train step per new LostGAN family of the port against the JAX
package's step, on the CPU.

The JAX reference step of ``tests/test_torch_port_step_knobs.py`` (line for
line ``layout2img_tpu/train/step.py``, with its ``"app" in out`` branches
for a D without the app head, dropout off, z and z_im given) and the port's
step run from the same weights (the port's seeded ones, read into JAX by
the JAX package's importer), batch and latents, at ch=4, b=2, o=8 slots (6
and 3 objects), f32, VGG off. The families here: the v1 mask trunk
(``lostgan``: ``lostgan128`` + ``d128``), the GCN context
(``graph_context_app``: ``graph128`` + ``d128_app``) and the part masks
(``context_part``: ``context128_part`` + ``d128``); the app-less D, 64 px
and 256 px are in ``test_torch_port_presets_step_b.py``.

Bars, those of ``tests/test_torch_port_train.py``: losses within 2e-3 and
the same metric keys (no app terms without the app head); each gradient
tensor's error norm within 1e-3 of its norm, except in a generator with
stage masks, whose layers up to its last mask head are held to 1e-2 (at
128 px that head is the PSP head, and these are the layers before it; at
256 px, with plain-conv heads, res1..res5: the bias gradients of
res4-res5, some 1e-5 of the largest norm and what is left after the mask
heads' BNs cancel the rest, miss 1e-3 of JAX's at ch=2), an absolute 1e-6
of the net's largest norm for a round-off zero (at 256 px 2e-6: a bias
before a batch-statistics BN sums 4x the pixels, and the port's round-off
there exceeds 1e-6);
parameters after the step within 2*lr, under 1% of elements beyond 1e-6;
SN u and BN running statistics within 1e-5 (1e-4 for the PSP bottleneck
BN and the app head's class embedding). None of this file's three
generators has stage masks: every gradient here is held to 1e-3.
"""

import pytest

from layout2img_tpu_torch.train.state import TrainConfig
from test_torch_port_step_knobs import (_few_threads, check_gradients, check_losses,  # noqa: F401
                                        check_params_and_state, make_setup, run_jax, run_port)

FAMILIES = {"lostgan": ("lostgan128", "d128"), "graph_context_app": ("graph128", "d128_app"),
            "context_part": ("context128_part", "d128")}
_CACHE = {}


def step_pair(family: str, ch: int = 4):
    """(port step, JAX step) of one family, run once."""
    if family not in _CACHE:
        gen_preset, disc_preset = FAMILIES[family]
        setup = make_setup(gen_preset=gen_preset, disc_preset=disc_preset, ch=ch,
                           from_port=True)
        cfg = TrainConfig(use_vgg_loss=False)
        _CACHE[family] = (run_port(setup, cfg), run_jax(setup, cfg, fast=family != "context_part"))
    return _CACHE[family]


@pytest.mark.parametrize("check", [check_losses, check_gradients, check_params_and_state])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_step_matches_jax(family, check):
    check(*step_pair(family))


def test_app_less_d_has_no_app_terms():
    port, ref = step_pair("lostgan")
    assert not any("app" in k for k in port.metrics) and set(port.metrics) == set(ref[4])
    port, _ = step_pair("graph_context_app")
    assert {"d_loss_rapp", "d_loss_fapp", "g_loss_app"} <= set(port.metrics)
