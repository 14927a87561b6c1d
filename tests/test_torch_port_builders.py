"""The port's string-spec builders (``nn/builders.py``) against the JAX
package's (``layout2img_tpu/nn/builders.py``), on the CPU: ``build_cnn``
(convs with strides, a residual block, pooling, nearest upsampling, the
flatten and linear layers) with batch, instance and no normalization, ReLU
and leaky ReLU, max and average pooling, in training (batch statistics; the
running statistics after the call) and in eval; ``build_mlp`` with and
without batch norm; ``cnn_out_channels``; and the specs both refuse.
Outputs and statistics at 1e-5 of their largest value, JAX's variables
converted by ``utils.convert.layout2im_state_dict_from_jax``.
"""

import numpy as np
import pytest

import jax

from layout2img_tpu.nn import builders as jb
from layout2img_tpu_torch.nn import builders as pb
from test_torch_port_layout2im import _load, _rel, _stats_match, _t
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)


ARCH = "I3,C3-8,R,C3-8-2,P2,U2,C1-4,FC-256-10,FC-10-5"


@pytest.mark.parametrize("norm,act,pool", [("batch", "relu", "max"),
                                           ("instance", "leakyrelu-0.2", "avg"),
                                           ("none", "leakyrelu", "max")])
def test_build_cnn_matches_jax(norm, act, pool):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    jmod, jout = jb.build_cnn(ARCH, normalization=norm, activation=act, pooling=pool)
    pmod, pout = pb.build_cnn(ARCH, normalization=norm, activation=act, pooling=pool)
    assert jout == pout == pb.cnn_out_channels(ARCH) == 5
    assert pb.cnn_out_channels("C3-8,C3-16-2") == jb.cnn_out_channels("C3-8,C3-16-2") == 16
    variables = jax.tree_util.tree_map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0), x)))
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda s: s + rng.uniform(0.1, 0.5, s.shape).astype(s.dtype), variables["batch_stats"])
    for train in (True, False):
        want, new = jmod.apply(variables, x, train=train, mutable=["batch_stats"])
        port = _load(pb.build_cnn(ARCH, normalization=norm, activation=act, pooling=pool)[0],
                     variables, train)
        got = port(_t(x).permute(0, 3, 1, 2))
        assert got.shape == (3, 5)
        _rel(got, want, 1e-5, f"train={train}")
        if train and norm == "batch":
            assert _stats_match(port, variables, new) == 8


@pytest.mark.parametrize("batch_norm,final", [("none", True), ("batch", False)])
def test_build_mlp_matches_jax(batch_norm, final):
    rng = np.random.default_rng(22)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    jmod = jb.build_mlp([10, 16, 8], activation="leakyrelu", batch_norm=batch_norm,
                        final_nonlinearity=final)
    variables = jax.tree_util.tree_map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0), x)))
    for train in (True, False):
        want, new = jmod.apply(variables, x, train=train, mutable=["batch_stats"])
        port = _load(pb.build_mlp([10, 16, 8], activation="leakyrelu", batch_norm=batch_norm,
                                  final_nonlinearity=final), variables, train)
        _rel(port(_t(x)), want, 1e-5, f"train={train}")
        if train and batch_norm == "batch":
            assert _stats_match(port, variables, new) == 2


def test_builders_refuse_what_jax_refuses():
    x = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="invalid layer"):
        jb.build_cnn("C3-8,X2")[0].init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="invalid layer"):
        pb.build_cnn("C3-8,X2")
    with pytest.raises(ValueError, match="invalid activation"):
        pb.build_mlp([2, 3], activation="tanh")
    with pytest.raises(ValueError, match="unrecognized normalization"):
        pb.build_cnn("C3-8,C3-8", normalization="group")
