"""The generator EMA, the train CLI's knob flags and the port's bench, on the CPU.

- EMA (``train/ema.py``, the JAX package's ``train/ema.py``): after each
  step ``e = decay * e + (1 - decay) * p`` from a copy of the initial
  parameters, at f32 round-off; the average never aliases the live
  parameters; the step's losses and updates are the same with it on.
- ``cli/train.py``: the JAX CLI's flags (``--mixed_precision``,
  ``--ema_decay``, ``--fused_d``, ``--remat``, ``--remat_d_blocks``,
  ``--d_obj_budget``, ``--g_obj_budget``, ``--obj_budget_force``) at ch=4,
  b=2; ``G_ema.pth`` (the EMA with the live buffers) loads in ``cli.sample``;
  ``check_obj_budgets`` refuses, warns and accepts as the JAX CLI's does.
- ``layout2img_tpu_torch.bench``: the JAX bench's knobs and defaults, and
  its one JSON line (metric name and keys), at ch=4 and b=2 on the CPU.
"""

import argparse
import json
import logging

import numpy as np
import pytest
import torch

from layout2img_tpu_torch import bench
from layout2img_tpu_torch.cli import sample as sample_cli
from layout2img_tpu_torch.cli import train as train_cli
from layout2img_tpu_torch.data.synthetic import synthetic_batch
from layout2img_tpu_torch.models.generators import make_generator
from layout2img_tpu_torch.train.ema import ema_init, ema_update
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

CH, NC, B, O = 4, 10, 2, 8
JAX_BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline"}  # bench.py:153-165


def _steps(cfg: TrainConfig, n: int):
    gen = init_generator(0, NC, device="cpu", ch=CH, num_mask_classes=NC)
    disc = init_discriminator(1, NC, device="cpu", ch=CH)
    state = create_train_state(gen, disc, cfg)
    step = make_train_step(state, cfg, deterministic=True)
    rng = np.random.default_rng(3)
    g = torch.Generator().manual_seed(4)
    history, metrics = [{k: p.detach().clone() for k, p in gen.named_parameters()}], []
    for _ in range(n):
        batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(rng, B, 128, O, NC).items()}
        batch["labels"] = batch["labels"].long()
        metrics.append(step(batch, g))
        history.append({k: p.detach().clone() for k, p in gen.named_parameters()})
    return state, history, metrics


@pytest.fixture(scope="module")
def ema_run():
    return _steps(TrainConfig(use_vgg_loss=False, ema_decay=0.5), 2)


def test_ema_is_the_running_average(ema_run):
    state, history, _ = ema_run
    for name, e in state.ema.items():
        want = history[0][name]
        for p in history[1:]:
            want = 0.5 * want + 0.5 * p[name]
        torch.testing.assert_close(e, want, rtol=1e-6, atol=1e-7, msg=name)
        assert e.dtype == torch.float32


def test_ema_never_aliases_the_live_parameters(ema_run):
    state = ema_run[0]
    params = dict(state.generator.named_parameters())
    assert set(state.ema) == set(params)
    for name, e in state.ema.items():
        assert e.data_ptr() != params[name].data_ptr()
    before = {k: v.clone() for k, v in state.ema.items()}
    with torch.no_grad():
        for p in params.values():
            p.add_(1.0)
    try:
        assert all(torch.equal(before[k], state.ema[k]) for k in before)
    finally:
        with torch.no_grad():
            for p in params.values():
                p.sub_(1.0)


def test_ema_does_not_change_the_step(ema_run):
    _, history, metrics = ema_run
    _, plain_history, plain_metrics = _steps(TrainConfig(use_vgg_loss=False), 2)
    for m, pm in zip(metrics, plain_metrics):
        assert {k: v.item() for k, v in m.items()} == {k: v.item() for k, v in pm.items()}
    for h, ph in zip(history, plain_history):
        assert all(torch.equal(h[k], ph[k]) for k in h)


def test_ema_update_formula():
    gen = make_generator("ours_d_context128", NC, device="cpu", ch=CH, num_mask_classes=NC)
    with torch.no_grad():
        for p in gen.parameters():
            p.fill_(2.0)
    ema = ema_init(gen)
    with torch.no_grad():
        for p in gen.parameters():
            p.fill_(4.0)
    ema_update(ema, gen, decay=0.75)
    assert all(torch.equal(e, torch.full_like(e, 2.5)) for e in ema.values())
    assert create_train_state(gen, gen, TrainConfig()).ema is None


def test_train_cli_knob_flags_and_g_ema(tmp_path):
    train_cli.main(["--steps", "2", "--batch_size", "2", "--ch", "4", "--no_vgg", "--device",
                    "cpu", "--out_path", str(tmp_path / "run"), "--log_every", "1",
                    "--mixed_precision", "--ema_decay", "0.9",
                    "--fused_d", "--remat", "gd", "--remat_d_blocks", "2", "--g_obj_budget", "6",
                    "--d_obj_budget", "5", "--obj_budget_force"])
    out = tmp_path / "run" / "synthetic" / "128" / "context_app_v2"
    lines = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    assert {"g_budget_overflow", "d_budget_overflow"} <= set(lines[0])
    g, g_ema = (torch.load(out / name, weights_only=True) for name in ("G.pth", "G_ema.pth"))
    assert set(g) == set(g_ema)
    params = {n for n, _ in make_generator("ours_d_context128", train_cli.SYNTHETIC_CLASSES,
                                           device="cpu", ch=4).named_parameters()}
    for k in g:
        if k in params:
            assert g[k].dtype == torch.float32 and not torch.equal(g[k], g_ema[k]), k
        else:  # buffers: the live generator's
            assert torch.equal(g[k], g_ema[k]), k
    sample_cli.main(["--weights", str(out / "G_ema.pth"), "--sample_path", str(tmp_path / "s"),
                     "--num_img", "1", "--batch_size", "2", "--device", "cpu"])
    assert len(list((tmp_path / "s").iterdir())) == 2 * sample_cli.SYNTHETIC_BATCHES


def _budget_args(g=0, d=0, force=False):
    return argparse.Namespace(g_obj_budget=g, d_obj_budget=d, obj_budget_force=force)


def test_check_obj_budgets(caplog):
    counts = np.arange(3, 9)
    log = logging.getLogger("test_budgets")
    with caplog.at_level(logging.INFO, logger="test_budgets"):
        train_cli.check_obj_budgets(counts, _budget_args(), log)
        assert not caplog.records
        train_cli.check_obj_budgets(counts, _budget_args(g=8, d=8), log)
        assert "max 8" in caplog.text and "WARNING" not in caplog.text
        with pytest.raises(SystemExit, match="GENERATED IMAGE"):
            train_cli.check_obj_budgets(counts, _budget_args(g=6), log)
        caplog.clear()
        train_cli.check_obj_budgets(counts, _budget_args(g=6, force=True), log)
        assert "accepted via --obj_budget_force" in caplog.text
        caplog.clear()
        train_cli.check_obj_budgets(counts, _budget_args(d=6), log)
        assert "from D's view only" in caplog.text and "33.33%" in caplog.text
        caplog.clear()
        train_cli.check_obj_budgets(None, _budget_args(d=6), log)
        assert "UNCHECKED" in caplog.text


def test_train_cli_refuses_a_g_budget_below_the_data():
    with pytest.raises(SystemExit, match="obj_budget_force"):
        train_cli.main(["--steps", "1", "--device", "cpu", "--g_obj_budget", "4"])


def test_bench_defaults_are_the_jax_bench_defaults():
    cfg = bench.config_from_env({})
    assert (cfg.batch, cfg.scan, cfg.scans, cfg.model, cfg.classes, cfg.obj, cfg.valid_max,
            cfg.mixed, cfg.fused_d, cfg.remat, cfg.remat_d_blocks, cfg.d_obj_budget,
            cfg.g_obj_budget) == (128, 10, 3, "ours_d_context128", 184, 8, 0, True, False, "none",
                                  0, 0, 0)
    env = {"BENCH_BATCH": "64", "BENCH_SCAN": "2", "BENCH_SCANS": "4", "BENCH_MODEL": "m",
           "BENCH_CLASSES": "179", "BENCH_OBJ": "31", "BENCH_VALID_MAX": "10", "BENCH_MIXED": "0",
           "BENCH_FUSED_D": "1", "BENCH_REMAT": "gd", "BENCH_REMAT_D_BLOCKS": "2",
           "BENCH_D_OBJ_BUDGET": "12", "BENCH_G_OBJ_BUDGET": "12"}
    assert bench.config_from_env(env) == bench.BenchConfig(
        batch=64, scan=2, scans=4, model="m", classes=179, obj=31, valid_max=10, mixed=False,
        fused_d=True, remat="gd", remat_d_blocks=2, d_obj_budget=12, g_obj_budget=12)


@pytest.mark.parametrize("env", [{}, {"BENCH_OBJ": "31", "BENCH_CLASSES": "179",
                                      "BENCH_VALID_MAX": "10", "BENCH_D_OBJ_BUDGET": "12",
                                      "BENCH_G_OBJ_BUDGET": "12"}])
def test_bench_prints_the_jax_bench_line(monkeypatch, capsys, env):
    for k, v in {"BENCH_BATCH": "2", "BENCH_SCAN": "1", "BENCH_SCANS": "2", **env}.items():
        monkeypatch.setenv(k, v)
    bench.main(["--device", "cpu", "--ch", "4", "--no_vgg"])
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == JAX_BENCH_KEYS
    assert line["metric"] == "gan_train_step_images_per_sec_128px" and line["unit"] == "img/s/chip"
    assert line["value"] > 0 and line["vs_baseline"] == round(line["value"] / 25.0, 3)
    assert "over 2 steps" in err
    assert ("g=12 d=12" if env else "g=0 d=0") in err
