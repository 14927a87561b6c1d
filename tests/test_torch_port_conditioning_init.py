"""The conditioning check's initial weights are the JAX script's own (on the
CPU).

The JAX script (``scripts/train_conditioning_check.py``) draws its LostGAN
flagship's G and D with ``create_train_state(jax.random.PRNGKey(0), ...)``.
``layout2img_tpu_torch/scripts/conditioning_init.json`` records, for the
flagship at the script's defaults and for ``graph128`` and
``context128_part`` with ``--no_app_head``, and for every variable of those
trees, its shape, its initializer and the flax scope
path and ``make_rng`` count its key was folded from; the port redraws them
in numpy (``utils/jax_random.py``). Here:

- the tables equal what flax does when the JAX script initializes (each
  ``Scope.param``/``Scope.variable`` call recorded with the key suffix of
  the ``make_rng`` calls it made, and its initializer identified by its
  values; ``..._init_tables.py`` for the flagship, ``..._init_presets.py``
  for the others); ``python tests/test_torch_port_conditioning_init.py``
  rewrites the file from that record;
- the port's numpy PRNG gives JAX's keys and bits exactly, and its floats to
  f32 round-off;
- the networks ``jax_initial_networks`` builds hold JAX's initial weights
  converted to the port's layout, to 1e-5 (2.2e-6 seen: XLA's and numpy's
  QR and ``log1p`` round differently), with the same BN statistics and SN
  vectors (those two files);
- the port's seeded draws (``cli.train``'s initializers) follow flax's
  distribution, leaf by leaf (here).
"""

import json

import flax.core.scope as flax_scope
import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax

from layout2img_tpu.models.discriminators import LayoutDiscriminator
from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.train.state import TrainConfig as JaxTrainConfig
from layout2img_tpu.train.state import create_train_state as jax_create_train_state
from layout2img_tpu_torch.scripts import train_conditioning_check as check
from layout2img_tpu_torch.utils import jax_random as jr
from layout2img_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                                generator_state_dict_from_jax)
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

KINDS = ("zeros", "ones", "orthogonal", "normal", "lecun_normal", "xavier_uniform",
         "xavier_normal", "uniform_fan_out")


def _draws(kind: str, key, leaf: np.ndarray) -> bool:
    """Whether initializer ``kind`` with ``key`` gives ``leaf``."""
    if key is None and kind not in ("zeros", "ones"):
        return False
    try:
        return np.allclose(jr.initializer(kind, key, leaf.shape), leaf, rtol=0, atol=1e-5)
    except IndexError:  # a fan-based initializer on a 1-d leaf
        return False


def _record(a) -> tuple[dict, dict]:
    """The JAX script's ``create_train_state`` for the LostGAN flagship, with
    every variable's key suffix recorded; returns (table, variables)."""
    log, calls = [], []
    real_rng, real_param, real_variable = (flax_scope.Scope.make_rng, flax_scope.Scope.param,
                                           flax_scope.Scope.variable)

    def make_rng(self, name="params"):
        key = real_rng(self, name)
        log.append(list(self.rngs["params"].suffix) + [self.rng_counters["params"]])
        return key

    def traced(real, collection):
        def fn(self, *args, **kwargs):
            col, name = (collection, args[0]) if collection else (args[0], args[1])
            start = len(log)
            out = real(self, *args, **kwargs)
            calls.append((col, list(self.path) + [name], log[start:]))
            return out
        return fn

    flax_scope.Scope.make_rng = make_rng
    flax_scope.Scope.param = traced(real_param, "params")
    flax_scope.Scope.variable = traced(real_variable, None)
    try:
        palette = check.make_palette(a.num_classes)
        gen = jax_make_generator(a.preset, a.num_classes, ch=a.ch, image_size=a.img_size,
                                 num_mask_classes=a.num_classes)
        disc = LayoutDiscriminator(num_classes=a.num_classes, image_size=a.img_size, ch=a.ch,
                                   app_head=not a.no_app_head)
        state = jax_create_train_state(jax.random.PRNGKey(0), gen, disc,
                                       check.make_batch(np.random.default_rng(99), a, palette),
                                       JaxTrainConfig(use_vgg_loss=False, mixed_precision=True))
    finally:
        flax_scope.Scope.make_rng, flax_scope.Scope.param, flax_scope.Scope.variable = (
            real_rng, real_param, real_variable)
    variables = {"generator": {"params": state.g_params, **state.g_state},
                 "discriminator": {"params": state.d_params, **state.d_state}}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    g_key, d_key, _ = jr.split(jr.prng_key(0), 3)
    roots = {"generator": g_key, "discriminator": d_key}
    table = {"config": check.init_config(a), "generator": [], "discriminator": []}
    for net in ("generator", "discriminator"):
        seen = set()
        for col, path, suffixes in calls:
            leaf = variables[net].get(col)
            for p in path:
                leaf = leaf.get(p) if isinstance(leaf, dict) else None
            if not isinstance(leaf, np.ndarray) or (col, *path) in seen:
                continue
            seen.add((col, *path))
            assert len(suffixes) <= 1, (col, path, suffixes)
            suffix = suffixes[0] if suffixes else None
            key = jr.fold_in_path(roots[net], tuple(suffix)) if suffix else None
            kind = next(k for k in KINDS if _draws(k, key, leaf))
            table[net].append([col, path, list(leaf.shape), kind, suffix])
    return table, variables


# every configuration with a table: the flagship at the script's defaults,
# and the other LostGAN rows of the JAX README's table, which
# ``..._init_presets.py`` records
TABLE_CONFIGS = ([], ["--preset", "graph128", "--no_app_head"],
                 ["--preset", "context128_part", "--no_app_head"])
CONFIGS = TABLE_CONFIGS[:1]


def check_tables(recorded) -> None:
    """Each recorded table equals the committed one of its configuration."""
    with open(check.INIT_TABLE) as f:
        committed = json.load(f)
    for table, variables in recorded:
        assert sum(len(table[n]) for n in ("generator", "discriminator")) == sum(
            len(jax.tree_util.tree_leaves(variables[n])) for n in ("generator", "discriminator"))
        table = json.loads(json.dumps(table))
        assert [t for t in committed if t["config"] == table["config"]] == [table]


def check_networks(variables, argv, nets=None) -> None:
    """The port's networks from the table (``nets``, else drawn here) hold
    JAX's initial weights."""
    gen, disc = nets or check.jax_initial_networks(check.parse_args(argv), "cpu")
    for net, port, want in (
            ("generator", gen, generator_state_dict_from_jax(variables["generator"], res_start=2)),
            ("discriminator", disc, discriminator_state_dict_from_jax(variables["discriminator"]))):
        got = port.state_dict()
        assert set(got) == set(want), net
        for k, v in want.items():
            np.testing.assert_allclose(got[k].double().numpy(), v.double().numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{net} {k}")


@pytest.fixture(scope="module")
def jax_nets():
    """``jax_initial_networks`` per configuration, each drawn once per file."""
    nets = {}

    def get(argv):
        key = tuple(argv)
        if key not in nets:
            nets[key] = check.jax_initial_networks(check.parse_args(argv), "cpu")
        return nets[key]

    return get


def test_numpy_prng_is_jax_prng():
    key = jax.random.split(jax.random.PRNGKey(7))[1]
    ours = jr.split(jr.prng_key(7))[1]
    assert np.array_equal(np.asarray(key), ours)
    assert np.array_equal(np.asarray(jax.random.fold_in(key, 12345)), jr.fold_in(ours, 12345))
    assert np.array_equal(np.asarray(jax.random.bits(key, (5, 7))), jr.random_bits(ours, (5, 7)))
    assert np.array_equal(np.asarray(jax.random.uniform(key, (999,))), jr.uniform(ours, (999,)))
    np.testing.assert_allclose(np.asarray(jax.random.normal(key, (10**5,))),
                               jr.normal(ours, (10**5,)), rtol=0, atol=1e-6)
    for name, init in (("orthogonal", fnn.initializers.orthogonal()),
                       ("lecun_normal", fnn.initializers.lecun_normal()),
                       ("xavier_uniform", fnn.initializers.xavier_uniform())):
        for shape in ((3, 3, 24, 48), (128, 384), (180, 12)):
            np.testing.assert_allclose(np.asarray(init(key, shape)),
                                       jr.initializer(name, ours, shape), rtol=0, atol=1e-6,
                                       err_msg=f"{name} {shape}")


def _spread(t: torch.Tensor) -> tuple[float, float]:
    """(std, largest distance from the mean in stds) of a leaf."""
    t = t.double()
    std = t.std().item()
    return std, (t - t.mean()).abs().max().item() / std


@pytest.mark.parametrize("argv", TABLE_CONFIGS, ids=("flagship", "graph128", "context128_part"))
def test_seeded_torch_init_draws_as_flax(argv, jax_nets):
    """The port's seeded draws (``torch_initial_networks``: ``cli.train``'s
    initializers) against the JAX script's initial weights, leaf by leaf:
    the same constant leaves; for each random leaf of 1000 values or more,
    its std within 10%, and its tail where JAX's is: within 2 of its stds
    (a uniform ends at 1.73), within 2 to 2.45 (a normal truncated at two of
    its standard deviations, such as flax's lecun-normal, ends at 2 / 0.8796
    = 2.27), or past 2.6 (a normal or orthogonal leaf)."""
    a = check.parse_args(argv)
    for net, port, want in zip(("generator", "discriminator"),
                               check.torch_initial_networks(a, "cpu"), jax_nets(argv)):
        got_sd, want_sd = port.state_dict(), want.state_dict()
        assert set(got_sd) == set(want_sd), net
        for k, w in want_sd.items():
            g = got_sd[k]
            if not w.is_floating_point():
                continue
            if w.numel() > 1 and torch.all(w == w.flatten()[0]):
                assert torch.equal(g, w), f"{net} {k}: constant {w.flatten()[0].item()} in JAX"
            elif w.numel() >= 1000:
                (w_std, w_tail), (g_std, g_tail) = _spread(w), _spread(g)
                assert 0.9 < g_std / w_std < 1.1, f"{net} {k}: std {g_std} against JAX's {w_std}"
                # 1000 normal or orthogonal values reach past 2.6 but for a chance of 1e-4,
                # and 1000 truncated ones past 2.0 but for less (the sample's std and mean
                # move the truncated tail by a few %)
                band = 0 if w_tail < 2.0 else 1 if w_tail <= 2.45 else 2
                assert band == (0 if g_tail < 2.0 else 1 if g_tail <= 2.45 else 2) and (
                    band < 2 or g_tail > 2.6), f"{net} {k}: tail {g_tail} against {w_tail}"


def test_other_configurations_have_no_table():
    assert check.jax_initial_networks(check.parse_args(["--ch", "8"]), "cpu") is None
    assert check.jax_initial_networks(check.parse_args(["--no_app_head"]), "cpu") is None
    assert check.jax_initial_networks(check.parse_args(["--preset", "graph128"]), "cpu") is None


if __name__ == "__main__":
    # write the committed tables anew from the JAX script's initializations:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_conditioning_init.py
    tables = [_record(check.parse_args(argv))[0] for argv in TABLE_CONFIGS]
    with open(check.INIT_TABLE, "w") as f:
        json.dump(json.loads(json.dumps(tables)), f, separators=(",", ":"))
    print(f"wrote {len(tables)} tables to {check.INIT_TABLE}")
