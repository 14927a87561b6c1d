"""The port's f32 train step learns the conditioning task as the JAX f32 step
does: ``test_torch_port_conditioning_steps.py``'s comparison in f32 (a file of
its own, so that the two JAX compiles run on two workers)."""

from test_torch_port_conditioning_steps import track
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)


def test_port_f32_step_tracks_the_jax_step():
    track(mixed=False)
