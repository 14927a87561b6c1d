"""The port's ``scripts/bench_inference.py`` and ``scripts/profile_step.py``
(``layout2img_tpu_torch/scripts/``) against the JAX repo's scripts of those
names, on the CPU at a small width (ch=4; the shapes are the benches' own).

- ``bench_inference``'s layouts are the JAX script's numpy draws, in its
  order, with ``BENCH_VALID_MAX``'s pads; its knobs have the JAX defaults.
- Its two timed functions, fed the latents that the JAX script's
  ``ed_sample`` and ``d_sample`` draw from one key (``jax.random``, split as
  they split it) and the same weights (the port's seeded init with its BN
  statistics and stage-mask alphas moved off 0/1, carried to JAX by the JAX
  package's ``torch_import``), match ``BgFgGenerator.apply`` and
  ``make_generator("ours_d_context128", 179).apply`` (eval, no statistics
  update) at the PARITY.md bar of 2e-3 in f32, and Ours-ED in bf16 (the
  weights and latents cast, boxes f32, as ``BENCH_BF16=1``) at 1e-2 (read:
  1.5e-3; two bf16 pipelines that round differently: JAX keeps the BN
  statistics in f32, the port casts them with the weights; f32 reads 5.9e-6). ``BENCH_VALID_MAX=10
  BENCH_OBJ_BUDGET=12`` runs G on 12 of 31 slots with z sliced from its
  full-width draw; it is held to the JAX function on all 31 slots of the
  same layouts (the script's budget is exact: the same images when K covers
  the valid slots), so one JAX compile serves both.
- ``bench_inference.main`` and ``profile_step.main`` run on ``--device cpu``
  at tiny sizes with one timed call and print every line, ``--roi_detail``'s
  included.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.models.generators import BgFgGenerator as JaxBgFgGenerator
from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.utils.casting import cast_floating as jax_cast_floating
from layout2img_tpu.utils.torch_import import import_bgfg_generator, import_lostgan_generator
from layout2img_tpu_torch.data.synthetic import PAD_BOX
from layout2img_tpu_torch.scripts import bench_inference, profile_step
from layout2img_tpu_torch.utils.convert import init_bgfg_generator, init_generator
from test_torch_port_step_knobs import FAST_COMPILE, _few_threads  # noqa: F401  (autouse)

CH = 4
TOL = 2e-3
BF16_TOL = 1e-2


def _jax_layouts(valid_max: int = 0) -> dict:
    """The JAX script's numpy draws, in its order."""
    rng_np = np.random.default_rng(0)
    b, o = 8, 8
    boxes = (rng_np.random((b, o, 4)) * 0.4 + 0.1).astype(np.float32)
    labels_f = rng_np.integers(1, 91, (b, o)).astype(np.int32)
    labels_b = rng_np.integers(1, 93, (b, o)).astype(np.int32)
    b2, o2 = 8, 31
    boxes2 = (rng_np.random((b2, o2, 4)) * 0.4 + 0.1).astype(np.float32)
    labels2 = rng_np.integers(1, 179, (b2, o2)).astype(np.int32)
    if valid_max:
        labels2[:, valid_max:] = 0
        boxes2[:, valid_max:] = np.asarray(PAD_BOX, np.float32)
    return {"ed_boxes": boxes, "ed_labels_fg": labels_f, "ed_labels_bg": labels_b,
            "vg_boxes": boxes2, "vg_labels": labels2}


def test_layouts_are_the_jax_scripts():
    for valid_max in (0, 10):
        got, want = bench_inference.layouts(valid_max), _jax_layouts(valid_max)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_knobs_have_the_jax_defaults():
    assert bench_inference.knobs_from_env({}) == bench_inference.Knobs(500, False, 0, 0)
    assert bench_inference.knobs_from_env(
        {"BENCH_K": "50", "BENCH_BF16": "1", "BENCH_VALID_MAX": "10", "BENCH_OBJ_BUDGET": "12"}
    ) == bench_inference.Knobs(50, True, 10, 12)


def _moved(gen: torch.nn.Module) -> torch.nn.Module:
    """``gen`` with its BN statistics and stage-mask alphas moved off 0/1."""
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in gen.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_mean":
                t.add_(torch.randn(t.shape, generator=g) * 0.02)
            elif leaf == "running_var":
                t.mul_(torch.rand(t.shape, generator=g) * 0.8 + 0.6)
            elif leaf.startswith("alpha"):
                t.copy_(torch.rand(t.shape, generator=g) * 4 - 2)
    return gen


def _compiled(fn, *args):
    """``fn`` jitted and compiled once at FAST_COMPILE for ``args``' shapes."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def ours_ed():
    """(port generator factory, JAX module, JAX variables)."""
    port = _moved(init_bgfg_generator(0, 91, 93, device="cpu", ch=CH))
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    variables = import_bgfg_generator(sd)
    jgen = JaxBgFgGenerator(num_fg_classes=91, num_bg_classes=93, ch=CH)

    def make():
        gen = init_bgfg_generator(0, 91, 93, device="cpu", ch=CH)
        gen.load_state_dict(sd, strict=True)
        return gen

    return make, jgen, variables


@pytest.fixture(scope="module")
def ours_d():
    """(port generator factory, compiled JAX apply, JAX variables)."""
    sd = _moved(init_generator(0, 179, device="cpu", ch=CH)).state_dict()
    sd = {k: v.clone() for k, v in sd.items()}
    jgen = jax_make_generator("ours_d_context128", 179, ch=CH)
    variables = import_lostgan_generator(sd)
    lay = _jax_layouts()
    z, zi = jnp.zeros((8, 31, 128)), jnp.zeros((8, 128))
    apply = _compiled(functools.partial(jgen.apply, train=False, update_stats=False),
                      variables, z, lay["vg_boxes"], lay["vg_labels"], zi)

    def make():
        gen = init_generator(0, 179, device="cpu", ch=CH)
        gen.load_state_dict(sd, strict=True)
        return gen

    return make, apply, variables


def _nchw(x) -> np.ndarray:
    return _np(x).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("bf16", [False, True])
def test_ours_ed_forward_matches_the_jax_scripts(ours_ed, bf16):
    make, jgen, variables = ours_ed
    zdt = jnp.bfloat16 if bf16 else jnp.float32
    if bf16:  # the JAX script's maybe_cast
        variables = {**variables, "params": jax_cast_floating(variables["params"], jnp.bfloat16)}
    lay = _jax_layouts()
    boxes, labels_f, labels_b = lay["ed_boxes"], lay["ed_labels_fg"], lay["ed_labels_bg"]
    b, o = 8, 8
    r = jax.random.split(jax.random.PRNGKey(3), 4)  # ed_sample's draws
    z_f = jax.random.truncated_normal(r[0], -2, 2, (b, o, 128), zdt)
    z_b = jax.random.truncated_normal(r[1], -2, 2, (b, o, 128), zdt)
    zi_f = jax.random.truncated_normal(r[2], -2, 2, (b, 128), zdt)
    zi_b = jax.random.truncated_normal(r[3], -2, 2, (b, 128), zdt)

    def ed_sample(v, z_f, z_b, zi_f, zi_b):
        return jgen.apply(v, z_f, boxes, labels_f, z_b, boxes, labels_b, zi_f, zi_b,
                          train=False, update_stats=False)

    latents = (z_f, z_b, zi_f, zi_b)
    want = _compiled(ed_sample, variables, *latents)(variables, *latents)
    cfg = bench_inference.ours_ed(torch.device("cpu"), bench_inference.Knobs(bf16=bf16),
                                  gen=make())
    got = cfg.forward(*(torch.from_numpy(_np(z).copy()) for z in latents))
    assert got.shape == (8, 3, 64, 64) and got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got.float().std() > 5e-3  # images, not a constant
    np.testing.assert_allclose(got.float().numpy(), _nchw(want), rtol=0,
                               atol=BF16_TOL if bf16 else TOL)


@pytest.mark.parametrize("valid_max,budget", [(0, 0), (10, 12)])
def test_ours_d_vg_forward_matches_the_jax_scripts(ours_d, valid_max, budget):
    make, apply, variables = ours_d
    lay = _jax_layouts(valid_max)
    r = jax.random.split(jax.random.PRNGKey(5))  # d_sample's draws
    z = jax.random.truncated_normal(r[0], -2, 2, (8, 31, 128), jnp.float32)
    zi = jax.random.truncated_normal(r[1], -2, 2, (8, 128), jnp.float32)
    want = apply(variables, z, lay["vg_boxes"], lay["vg_labels"], zi)
    cfg = bench_inference.ours_d_vg(torch.device("cpu"), bench_inference.Knobs(
        valid_max=valid_max, obj_budget=budget), gen=make())
    got = cfg.forward(torch.from_numpy(_np(z).copy()), torch.from_numpy(_np(zi).copy()))
    assert got.shape == (8, 3, 128, 128) and got.std() > 5e-3
    np.testing.assert_allclose(got.numpy(), _nchw(want), rtol=0, atol=TOL)
    assert cfg.name.endswith("(valid 10, budget 12)" if budget else "b8")


def test_bench_inference_main_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(bench_inference, "WARMUP", 0)  # one call a configuration
    results = bench_inference.main(["--device", "cpu", "--ch", str(CH)], env={"BENCH_K": "1"})
    lines = capsys.readouterr().out.splitlines()
    assert [r["name"] for r in results] == ["Ours-ED 64px infer b8", "Ours-D 128px VG infer b8"]
    assert all(r["calls"] == 1 and r["ms"] > 0 for r in results)
    assert len(lines) == 2 and all("ms/batch" in ln and "img/s/card" in ln for ln in lines)


def test_profile_step_main_prints_every_component(capsys):
    ms = profile_step.main(["--device", "cpu", "--ch", str(CH), "--batch_size", "2",
                            "--objects", "4", "--num_classes", "10", "--img_size", "64", "--k",
                            "1", "--roi_detail"])
    out = capsys.readouterr().out
    names = ["G forward (eval)", "D forward", "RoI dual-scale (both crops)",
             "RoI small-scale only", "RoI large-scale only", "VGG loss forward",
             "full step (no VGG)", "full step (VGG)"]
    assert list(ms) == names and all(v > 0 for v in ms.values())
    assert out.splitlines()[0] == "[ours_d_context128 b=2 o=4 nc=10 s=64]"
    for name in names:
        assert f"{name:34s}" in out and "ms/step" in out
    assert "compute-both overhead" in out and "of the D forward" in out
