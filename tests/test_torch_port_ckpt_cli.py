"""Checkpoints, resume, preemption, the NaN guard and the CLIs of the port,
on the CPU at a tiny size (ch=4, 64 px).

- ``train/checkpoint.py``: a save/restore round trip is bit-exact (both
  networks' parameters, SN ``weight_u``/``weight_v`` and BN statistics,
  both Adams' moments and step counts, the EMA, the step); the masters stay
  f32 under mixed precision; the 5 newest steps are kept; the JAX EMA rules
  (a checkpoint's EMA is restored into a state without one; a state that
  wants one from a checkpoint without starts from a copy of the restored
  parameters); another ``--ch`` raises; ``AsyncSaver`` writes the state of
  the moment ``save`` was called.
- ``cli/train.py`` from on-disk COCO and VG fixtures (as ``tests/test_data.py``
  does for JAX) into the JAX layout ``<out>/<dataset>/<size>/<model>``;
  ``--resume`` continues the step count; SIGTERM saves and exits 0; the NaN
  guard exits 3 and keeps the last good checkpoint, at a log point and in
  the pre-save windows of an epoch save and of the final save
  (``tests/test_preemption.py``'s cases).
- ``--torch_ckpt_g/d`` and ``--vgg_weights``: the port CLI's first step
  from reference dicts against a JAX step on the JAX package's import of
  the same dicts (``legacy_attention``), the same latents and batch: every
  first-step loss within 2e-3 (``PERF.md`` §6's loss bar).
- ``cli/sample.py --ckpt_dir`` (EMA preferred) and ``--dataset coco``;
  ``cli/export_torch.py`` round-trips; the multi-GPU flags raise, ``--l2i_fusion`` parses.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from layout2img_tpu.data.synthetic import SyntheticLayoutDataset as JaxSyntheticLayoutDataset
from layout2img_tpu.losses.perceptual import VGGLoss as JaxVGGLoss
from layout2img_tpu.losses.perceptual import load_torch_vgg19_features as jax_load_vgg
from layout2img_tpu.models.discriminators import make_discriminator as jax_make_discriminator
from layout2img_tpu.models.generators import make_generator as jax_make_generator
from layout2img_tpu.utils.torch_import import import_lostgan_discriminator, import_lostgan_generator
from layout2img_tpu_torch.cli import export_torch
from layout2img_tpu_torch.cli import sample as sample_cli
from layout2img_tpu_torch.cli import train as train_cli
from layout2img_tpu_torch.data.synthetic import (synthetic_batch, write_synthetic_coco,
                                                 write_synthetic_stuff, write_synthetic_vg)
from layout2img_tpu_torch.models.discriminators import make_discriminator
from layout2img_tpu_torch.train.checkpoint import AsyncSaver, CheckpointManager
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator, init_vgg
from layout2img_tpu_torch.utils.reference import load_torch_vgg19_features, reference_state_dict
from test_torch_port_step_knobs import _few_threads, fast_jit  # noqa: F401  (autouse)
from test_torch_port_train import _jax_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CH, NC, B, SIZE = 4, 10, 2, 64
TINY = ["--img_size", "64", "--ch", "4", "--no_vgg", "--batch_size", "2", "--device", "cpu"]


# ---- checkpoints ----

def _state(seed: int = 0, ch: int = CH, **cfg_kw):
    cfg = TrainConfig(use_vgg_loss=False, **cfg_kw)
    gen = init_generator(seed, NC, device="cpu", ch=ch, image_size=SIZE, num_mask_classes=NC)
    disc = init_discriminator(seed + 1, NC, device="cpu", ch=ch, image_size=SIZE)
    return create_train_state(gen, disc, cfg), cfg


def _trained(steps: int = 2, **cfg_kw):
    state, cfg = _state(**cfg_kw)
    step = make_train_step(state, cfg)
    rng, g = np.random.default_rng(3), torch.Generator().manual_seed(4)
    for _ in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(rng, B, SIZE, 8, NC).items()}
        batch["labels"] = batch["labels"].long()
        step(batch, g)
    return state


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _same_state(a, b) -> None:
    assert a.step == b.step
    for get in (lambda s: s.generator.state_dict(), lambda s: s.discriminator.state_dict(),
                lambda s: s.g_opt.state_dict(), lambda s: s.d_opt.state_dict(),
                lambda s: s.ema or {}):
        fa, fb = _flat(get(a)), _flat(get(b))
        assert fa.keys() == fb.keys()
        for k, v in fa.items():
            if isinstance(v, torch.Tensor):
                assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k
            else:
                assert v == fb[k], k


@pytest.mark.parametrize("mixed", [False, True])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, mixed):
    state = _trained(mixed_precision=mixed, ema_decay=0.9)
    assert state.g_opt.state and any(k.endswith("weight_u") for k in state.generator.state_dict())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    ck = mgr.read()
    assert all(v.dtype == torch.float32 for k, v in ck["generator"].items()
               if not k.endswith("num_batches_tracked"))
    fresh, _ = _state(seed=5, mixed_precision=mixed, ema_decay=0.9)
    mgr.restore(fresh)
    _same_state(fresh, state)
    assert mgr.all_steps() == [2]


def test_checkpoint_keeps_the_five_newest(tmp_path):
    state, _ = _state()
    mgr = CheckpointManager(str(tmp_path))
    for step in range(1, 8):
        state.step = step
        mgr.save(state)
    assert mgr.all_steps() == [3, 4, 5, 6, 7] and mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5", "6", "7"]
    assert os.listdir(tmp_path / "7") == ["state.pt"]


def test_checkpoint_ema_rules(tmp_path):
    with_ema = _trained(ema_decay=0.5)
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(with_ema)
    plain, _ = _state(seed=5)
    assert plain.ema is None
    mgr.restore(plain)  # the checkpoint's EMA comes along
    assert all(torch.equal(plain.ema[k], v) for k, v in with_ema.ema.items())

    mgr = CheckpointManager(str(tmp_path / "b"))
    mgr.save(_trained())
    wants, _ = _state(seed=5, ema_decay=0.5)
    mgr.restore(wants)  # starts from a copy of the restored parameters
    params = dict(wants.generator.named_parameters())
    assert wants.ema.keys() == params.keys()
    for k, e in wants.ema.items():
        assert torch.equal(e, params[k]) and e.data_ptr() != params[k].data_ptr()


def test_checkpoint_wrong_ch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state()[0])
    wide, _ = _state(ch=8)
    with pytest.raises(RuntimeError, match="size mismatch"):
        mgr.restore(wide)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(wide)


def test_async_saver_writes_the_state_of_the_call(tmp_path):
    state = _trained(steps=1, ema_decay=0.5)
    want = {k: v.clone() for k, v in state.generator.state_dict().items()}
    saver = AsyncSaver(CheckpointManager(str(tmp_path)))
    saver.save(state)
    with torch.no_grad():  # the next step's in-place update, at once
        for p in state.generator.parameters():
            p.add_(1.0)
    saver.wait()
    got = saver.read()["generator"]
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert saver.latest_step() == 1


# ---- the train CLI ----

def _run_dir(out, dataset="synthetic", model="context_app_v2", size=SIZE):
    return os.path.join(out, dataset, str(size), model)


def _steps_logged(run: str) -> list[int]:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(ln)["step"] for ln in f]


@pytest.fixture(scope="module")
def coco_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    _, inst = write_synthetic_coco(root, 4, width=96, height=80)
    return ["--coco_image_dir", root, "--coco_instances", inst,
            "--coco_stuff", write_synthetic_stuff(root, inst)]


def test_train_from_on_disk_coco_then_resume(tmp_path, coco_data):
    out = str(tmp_path / "out")
    args = ["--dataset", "coco", *coco_data, *TINY, "--out_path", out, "--log_every", "2",
            "--save_every_epochs", "1"]
    train_cli.main(args + ["--total_epoch", "2"])  # 4 images, doubled by flips: 4 steps an epoch
    run = _run_dir(out, "coco")
    assert CheckpointManager(os.path.join(run, "ckpt")).all_steps() == [4, 8]
    saved = CheckpointManager(os.path.join(run, "ckpt")).read(8)
    assert sorted(os.listdir(os.path.join(run, "images"))) == sorted(
        f"{kind}_{s:08d}.png" for kind in ("fake", "real") for s in (2, 4, 6, 8))
    train_cli.main(args + ["--total_epoch", "1", "--resume", "--async_ckpt"])
    assert _steps_logged(run) == [2, 4, 6, 8, 10, 12]
    mgr = CheckpointManager(os.path.join(run, "ckpt"))
    assert mgr.all_steps() == [4, 8, 12]
    assert all(torch.equal(v, saved["generator"][k])
               for k, v in mgr.read(8)["generator"].items())  # the resumed-from step untouched
    for line in open(os.path.join(run, "metrics.jsonl")):
        assert all(np.isfinite(v) for v in json.loads(line).values())
    disc = make_discriminator("d128_app", 184, device="cpu", ch=CH, image_size=SIZE)
    disc.load_state_dict(torch.load(os.path.join(run, "D.pth"), weights_only=True), strict=True)
    assert "resumed from step 8" in open(os.path.join(run, "log.txt")).read()


def test_train_from_on_disk_vg(tmp_path):
    vocab, h5, root = write_synthetic_vg(str(tmp_path / "vg"), 2, width=96, height=80,
                                         objects_per_image=6, num_classes=179)
    out = str(tmp_path / "out")
    train_cli.main(["--dataset", "vg", "--vg_vocab", vocab, "--vg_h5", h5, "--vg_image_dir", root,
                    *TINY, "--out_path", out, "--log_every", "1", "--total_epoch", "1",
                    "--g_obj_budget", "6", "--d_obj_budget", "6"])
    run = _run_dir(out, "vg")
    lines = [json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl"))]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert lines[0]["g_budget_overflow"] == 0.0 and np.isfinite(lines[-1]["g_loss"])
    assert CheckpointManager(os.path.join(run, "ckpt")).all_steps() == [2]


def _saved(out: str) -> list[int]:
    return CheckpointManager(os.path.join(_run_dir(out), "ckpt")).all_steps()


SYNTH = ["--dataset", "synthetic", "--steps_per_epoch", "3", *TINY]


def test_sigterm_saves_and_exits_zero(tmp_path):
    out = str(tmp_path)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "layout2img_tpu_torch.cli.train", *SYNTH, "--total_epoch", "1000",
         "--log_every", "1", "--save_every_epochs", "100000", "--out_path", out],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    metrics = os.path.join(_run_dir(out), "metrics.jsonl")
    deadline = time.time() + 120
    while time.time() < deadline and proc.poll() is None:
        if os.path.exists(metrics) and len(open(metrics).readlines()) >= 2:
            break
        time.sleep(0.2)
    assert proc.poll() is None, proc.communicate()[0]
    proc.send_signal(signal.SIGTERM)
    text, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, text
    assert "SIGTERM: saving checkpoint" in text, text
    logged = _steps_logged(_run_dir(out))
    assert _saved(out) == [logged[-1]]  # the step that finished after the signal


@pytest.mark.parametrize("case", ["log_point", "epoch_save", "final_save"])
def test_nan_guard_keeps_the_last_good_checkpoint(tmp_path, caplog, case):
    """Metrics poisoned from step 5 (``--fault_inject_nan_at``), epochs of 3
    steps. At a log point (``--log_every 1``) or before the epoch-2 save
    (``--log_every 100``): exit 3, the epoch-1 save at step 3 kept alone.
    Before the final save (a run resumed from that save with no epoch save
    of its own): exit 3 and the step-3 checkpoint's bytes untouched."""
    out = str(tmp_path)
    args = [*SYNTH, "--out_path", out, "--fault_inject_nan_at", "5", "--save_every_epochs", "1"]
    if case == "final_save":
        train_cli.main([*SYNTH, "--out_path", out, "--total_epoch", "1", "--save_every_epochs",
                        "1", "--log_every", "100"])
        before = open(os.path.join(_run_dir(out), "ckpt", "3", "state.pt"), "rb").read()
        args = [*SYNTH, "--out_path", out, "--fault_inject_nan_at", "5", "--resume",
                "--total_epoch", "1", "--save_every_epochs", "100", "--log_every", "100"]
    else:
        args += ["--total_epoch", "10" if case == "log_point" else "2",
                 "--log_every", "1" if case == "log_point" else "100"]
    with pytest.raises(SystemExit) as exit_info:
        train_cli.main(args)
    assert exit_info.value.code == 3
    text = open(os.path.join(_run_dir(out), "log.txt")).read()
    assert ("non-finite metrics at step 5:" if case == "log_point"
            else "non-finite metrics at step 6 (pre-save check)") in text
    assert _saved(out) == [3]
    if case == "final_save":
        assert open(os.path.join(_run_dir(out), "ckpt", "3", "state.pt"), "rb").read() == before
    assert not os.path.exists(os.path.join(_run_dir(out), "G.pth")) or case == "final_save"


@pytest.mark.parametrize("flag,item", [(["--l2i_fusion", "convlstm"], 5),
                                       (["--model_parallel", "2"], 6), (["--mp_mode", "spatial"], 6),
                                       (["--preempt_sync_every", "5"], 6)])
def test_later_slice_flags_name_the_roadmap(tmp_path, flag, item):
    """The flags of ported ROADMAP items: ``--l2i_fusion`` (item 5) is the
    layout2im fusion flag, checked against its choices;
    ``--preempt_sync_every`` (item 6's data mesh) is an int that nothing
    refuses; the 2-D mesh's (item 6): ``--model_parallel 2`` in one process
    is refused, naming both numbers, and ``--model_parallel 2 --mp_mode
    spatial`` trains Ours-ED as before, logging that the flags change
    nothing for it (the JAX CLI ignores them there)."""
    if flag[0] in ("--l2i_fusion", "--preempt_sync_every"):
        args = train_cli.parse_args([*SYNTH, *flag])
        name, bad = (("l2i_fusion", "no_such_fusion") if item == 5
                     else ("preempt_sync_every", "often"))
        assert str(getattr(args, name)) == flag[1]
        with pytest.raises(SystemExit):
            train_cli.parse_args([*SYNTH, flag[0], bad])
        return
    out = str(tmp_path / "o")
    if flag[0] == "--model_parallel":
        with pytest.raises(SystemExit, match="1 ranks not divisible by --model_parallel 2"):
            train_cli.main([*SYNTH, "--out_path", out, *flag])
        return
    train_cli.main([*SYNTH, "--out_path", out, "--model", "ours_ed", "--steps", "1",
                    "--model_parallel", "2", *flag])
    log = open(os.path.join(_run_dir(out, model="ours_ed"), "log.txt")).read()
    assert "--model_parallel 2 (--mp_mode spatial) changes nothing for --model ours_ed" in log
    ckpt = CheckpointManager(os.path.join(_run_dir(out, model="ours_ed"), "ckpt"))
    assert ckpt.all_steps() == [1]


def test_img_size_guard(tmp_path):
    with pytest.raises(SystemExit, match="use --model ours_d_256"):
        train_cli.main(["--img_size", "256", "--device", "cpu", "--out_path", str(tmp_path)])


# ---- reference weights against the JAX import ----

def test_reference_weights_first_step_matches_jax(tmp_path):
    """The port CLI's first step from reference G, D (under ``obD.``) and
    bare-key VGG dicts against a JAX step on the JAX import of the same
    files, with the CLI's batch and latents. At 64 px the Ours-D context
    generator has no PSP head, so the step has no dropout."""
    g_path, d_path, v_path = (str(tmp_path / n) for n in ("G.pth", "D.pth", "vgg.pth"))
    torch.save(init_generator(10, 184, device="cpu", ch=CH, image_size=SIZE).state_dict(), g_path)
    torch.save({f"obD.{k}": v for k, v in init_discriminator(
        11, 184, device="cpu", ch=CH, image_size=SIZE).state_dict().items()}, d_path)
    vgg = {k.removeprefix("features."): v for k, v in init_vgg(12, "cpu").state_dict().items()}
    for i in (30, 32, 34):  # torchvision's convs past relu5_1, which the JAX loader reads too
        vgg |= {f"{i}.weight": torch.zeros(512, 512, 3, 3), f"{i}.bias": torch.zeros(512)}
    torch.save(vgg, v_path)
    out = str(tmp_path / "out")
    train_cli.main(["--dataset", "synthetic", "--img_size", "64", "--ch", "4", "--batch_size", "2",
                    "--device", "cpu", "--steps", "1", "--log_every", "1", "--out_path", out,
                    "--torch_ckpt_g", g_path, "--torch_ckpt_d", d_path, "--vgg_weights", v_path])
    got = json.loads(open(os.path.join(_run_dir(out), "metrics.jsonl")).readline())

    jgen = jax_make_generator("ours_d_context128", 184, ch=CH, image_size=SIZE,
                              legacy_attention=True)
    jdisc = jax_make_discriminator("d128_app", 184, ch=CH, image_size=SIZE)
    g_vars = import_lostgan_generator(torch.load(g_path, weights_only=True))
    d_vars = import_lostgan_discriminator(torch.load(d_path, weights_only=True))
    batch = next(iter(JaxSyntheticLayoutDataset(2, SIZE, 8, 184, seed=0, steps=1)))
    rng = torch.Generator().manual_seed(0)  # the CLI's latent generator
    z = torch.randn((2, 8, 128), generator=rng).numpy()
    z_im = torch.randn((2, 128), generator=rng).numpy()
    step = fast_jit(lambda gv, dv, bt, z, zi: _jax_step(jgen, jdisc, gv, dv, bt, z, zi,
                                                        TrainConfig()))
    *_, metrics, _, fake = step(g_vars, d_vars, batch, z, z_im)
    feat = JaxVGGLoss(jax_load_vgg(v_path))(fake, batch["images"])
    want = {k: float(v) for k, v in metrics.items()}
    want["feat_loss"] = float(feat)
    want["g_loss"] += want["feat_loss"]
    assert set(got) - {"step", "time"} == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 2e-3, (k, got[k], v)


def test_vgg_weights_take_both_key_forms(tmp_path):
    sd = init_vgg(3, "cpu").state_dict()
    torch.save(sd, tmp_path / "full.pth")
    torch.save({**{k.removeprefix("features."): v for k, v in sd.items()},
                "34.weight": torch.zeros(1)}, tmp_path / "bare.pth")
    for name in ("full.pth", "bare.pth"):
        got = load_torch_vgg19_features(str(tmp_path / name)).state_dict()
        assert got.keys() == sd.keys() and all(torch.equal(got[k], v) for k, v in sd.items())
    with pytest.raises(ValueError, match="VGG19"):
        torch.save({"0.weight": torch.zeros(1)}, tmp_path / "bad.pth")
        load_torch_vgg19_features(str(tmp_path / "bad.pth"))


# ---- sampling and export from checkpoints ----

@pytest.fixture(scope="module")
def ema_run(tmp_path_factory, coco_data):
    out = str(tmp_path_factory.mktemp("ema"))
    train_cli.main([*SYNTH, "--out_path", out, "--total_epoch", "1", "--ema_decay", "0.5",
                    "--log_every", "100"])
    return out


def test_sample_from_checkpoint_prefers_ema(tmp_path, ema_run, coco_data):
    run = _run_dir(ema_run)
    common = ["--img_size", "64", "--batch_size", "3", "--num_img", "2", "--device", "cpu",
              "--max_layouts", "4"]
    sample_cli.main(["--ckpt_dir", os.path.join(run, "ckpt"), "--dataset", "coco", *coco_data,
                     *common, "--sample_path", str(tmp_path / "ckpt")])
    sample_cli.main(["--weights", os.path.join(run, "G_ema.pth"), "--dataset", "coco", *coco_data,
                     *common, "--sample_path", str(tmp_path / "ema")])
    names = sorted(os.listdir(tmp_path / "ckpt"))
    # two batches of 3 (the val split: 4 layouts, no flips; the tail padded), 2 draws each
    assert names == sorted(f"sample{i}_numb{j}.jpg" for i in range(4) for j in range(2))
    for n in names:
        assert (tmp_path / "ckpt" / n).read_bytes() == (tmp_path / "ema" / n).read_bytes(), n
    with pytest.raises(SystemExit, match="one of"):
        sample_cli.main(["--device", "cpu"])


def test_export_torch_round_trips(tmp_path, ema_run):
    ckpt_dir = os.path.join(_run_dir(ema_run), "ckpt")
    ck = CheckpointManager(ckpt_dir).read()
    export_torch.main(["--ckpt_dir", ckpt_dir, "--out_g", str(tmp_path / "G.pth"),
                       "--out_d", str(tmp_path / "D.pth")])
    g = torch.load(tmp_path / "G.pth", weights_only=True)
    assert g.keys() == ck["generator"].keys()
    assert all(torch.equal(g[k], ck["ema"].get(k, v)) for k, v in ck["generator"].items())
    d = torch.load(tmp_path / "D.pth", weights_only=True)
    assert all(k.startswith("obD.") for k in d)
    disc = make_discriminator("d128_app", 184, device="cpu", ch=CH, image_size=SIZE)
    disc.load_state_dict(reference_state_dict(d), strict=True)
    gen = sample_cli.load_generator(str(tmp_path / "G.pth"), torch.device("cpu"), image_size=SIZE)
    assert all(torch.equal(v, g[k]) for k, v in gen.state_dict().items())
    export_torch.main(["--ckpt_dir", ckpt_dir, "--out_g", str(tmp_path / "raw.pth"), "--no_ema",
                       "--module_prefix"])
    raw = torch.load(tmp_path / "raw.pth", weights_only=True)
    assert all(torch.equal(raw[f"module.{k}"], v) for k, v in ck["generator"].items())
