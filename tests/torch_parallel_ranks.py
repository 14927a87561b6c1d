"""Helpers of the data-parallel tests (``tests/test_torch_port_parallel*.py``):
start W ranks over gloo on the CPU with ``torch.multiprocessing``, each with
torchrun's variables set, under a time limit of its own; and the rank
programs those tests run. This module imports torch and the port only, so
that the ranks start without JAX."""

from __future__ import annotations

import os
import socket
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC, O, IMG, CH = 10, 6, 64, 4
B_RANK = 2  # images per rank


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn, world: int, port: int, threads: int, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    fn(rank, *args)


def start_ranks(fn, world: int, *args, threads: int = 1):
    """Start ``fn(rank, *args)`` in ``world`` spawned processes as the ranks
    of one run; ``wait_ranks`` joins them."""
    return mp.start_processes(_entry, args=(fn, world, free_port(), threads, args), nprocs=world,
                              join=False, start_method="spawn")


def run_ranks(fn, world: int, *args, timeout: float = 60.0, threads: int = 1):
    """``start_ranks`` and ``wait_ranks``."""
    return wait_ranks(start_ranks(fn, world, *args, threads=threads), timeout)


def wait_ranks(ctx, timeout: float):
    """Join the ranks; raise if any fails or they outlast ``timeout``
    seconds (every process is then killed)."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return ctx


# ---- the train step under 2 ranks against the one-process step ----

STEP_CONFIGS = {
    "f32_ema": dict(cfg=dict(ema_decay=0.999)),
    "mixed": dict(cfg=dict(mixed_precision=True)),
    "remat_gd": dict(cfg=dict(remat="gd")),
    "fused_d": dict(cfg=dict(fused_d=True)),
    "budgets": dict(cfg=dict(g_obj_budget=4, d_obj_budget=3)),
    "v1_trunk": dict(gen="lostgan128", disc="d128"),
    "parts": dict(gen="context128_part", disc="d128"),
}
STEPS = 2


def global_batch(seed: int = 3, b: int = 2 * B_RANK) -> dict[str, torch.Tensor]:
    """b synthetic layouts (some with pad slots) and images, from a numpy seed."""
    from layout2img_tpu_torch.data.synthetic import synthetic_batch

    batch = synthetic_batch(np.random.default_rng(seed), b, IMG, O, NC, min_objects=2)
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["labels"] = out["labels"].long()
    return out


def lostgan_state(name: str):
    """A train state and config of ``STEP_CONFIGS[name]`` from seeded draws."""
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator

    spec = STEP_CONFIGS[name]
    gen = init_generator(0, NC, preset=spec.get("gen", "ours_d_context128"), device="cpu", ch=CH,
                         image_size=IMG)
    disc = init_discriminator(1, NC, preset=spec.get("disc", "d128_app"), device="cpu", ch=CH,
                              image_size=IMG)
    cfg = TrainConfig(use_vgg_loss=False, **spec.get("cfg", {}))
    return create_train_state(gen, disc, cfg), cfg


def run_lostgan(state, cfg, batch: dict, steps: int = STEPS) -> list[dict]:
    """``steps`` steps of the LostGAN step with live dropout, the latents
    from ``Generator().manual_seed(5)`` and the global generator seeded 11;
    after each step its metrics and a copy of the whole state."""
    from layout2img_tpu_torch.train.step import make_train_step

    torch.manual_seed(11)
    rng = torch.Generator().manual_seed(5)
    step = make_train_step(state, cfg)
    out = []
    for _ in range(steps):
        metrics = {k: float(v) for k, v in step(batch, rng).items()}
        out.append({"metrics": metrics, "state": state_tensors(state)})
    return out


def state_tensors(state) -> dict[str, torch.Tensor]:
    """Copies of every tensor of a train state."""
    from layout2img_tpu_torch.parallel.mesh import state_tensors as live

    return {name: t.detach().clone() for name, t in live(state).items()}


def kind(name: str) -> str:
    """A state leaf's kind: ``adam`` (optimizer state), ``param``
    (parameters and EMA) or ``state`` (SN vectors, BN statistics)."""
    if "_opt." in name:
        return "adam"
    if name.startswith("ema") or not any(s in name for s in ("weight_u", "weight_v", "running")):
        return "param"
    return "state"


def compare(ref: dict, got: dict, digests: list) -> dict:
    """One step of a 2-rank run against the one-process step: both metrics,
    the largest elementwise error of each kind of float leaf (and its leaf;
    for the Adam moments relative to the tensor's largest element, or to
    1e-3 of the optimizer's largest where that is larger), the share of
    parameter and EMA elements more than 1e-6 apart, the relative error
    ||got - ref|| / ||ref|| of each optimizer's first and second moments taken
    as one vector (the largest of the four), the non-float leaves that
    differ, and the first leaf whose bits differ across the ranks (None if
    none)."""
    worst, other = {}, []
    beyond = total = 0
    sq = {}  # (optimizer, moment) -> [sum of squared errors, sum of squares]
    largest = {opt: max(w.abs().max().item() for k, w in ref["state"].items()
                        if k.startswith(opt) and w.is_floating_point() and w.numel())
               for opt in ("g_opt", "d_opt")}
    for k, w in ref["state"].items():
        g = got["state"][k]
        if not w.is_floating_point():
            if not torch.equal(g, w):
                other.append(k)
            continue
        diff = (g - w).abs()
        err = diff.max().item() if w.numel() else 0.0
        if kind(k) == "param":
            beyond += int((diff > 1e-6).sum())
            total += w.numel()
        if kind(k) == "adam" and w.numel():  # relative to the tensor's largest element
            moment = k.rsplit(".", 1)[1]
            if moment != "step":
                acc = sq.setdefault((k[:5], moment), [0.0, 0.0])
                acc[0] += diff.double().square().sum().item()
                acc[1] += w.double().square().sum().item()
            err /= max(w.abs().max().item(), 1e-3 * largest[k[:5]])
        if err >= worst.get(kind(k), (0.0, ""))[0]:
            worst[kind(k)] = (err, k)
    moments = {f"{opt}.{m}": (e / max(n, 1e-30)) ** 0.5 for (opt, m), (e, n) in sq.items()}
    differ = next((a[0] for a, b in zip(digests[0], digests[1]) if a != b), None)
    return {"ref_metrics": ref["metrics"], "metrics": got["metrics"], "worst": worst,
            "param_share": beyond / max(total, 1), "moments": moments,
            "nonfloat_differ": other, "ranks_differ": differ}


def everyone_bits(mesh, steps: list[dict]) -> list:
    """Every rank's bits after each of its steps: [rank][step] = digests of
    the state and the metrics."""
    import torch.distributed as dist

    from layout2img_tpu_torch.parallel import mesh as data_mesh

    mine = [data_mesh.digests(s["state"]) + [("metrics", repr(sorted(s["metrics"].items())))]
            for s in steps]
    everyone: list = [None] * mesh.world
    dist.all_gather_object(everyone, mine)
    return everyone


FAMILIES = ("bgfg", "layout2im")
# which rank runs which one-process reference, so that each takes about as long
REFERENCES = ({"f32_ema", "mixed", "remat_gd", "fused_d", "budgets", "bgfg"},
              {"v1_trunk", "parts", "layout2im"})


def parallel_rank(rank: int, names: list[str], out_dir: str) -> None:
    """Rank program of ``tests/test_torch_port_parallel.py``, in one process
    group: ``reductions``; then each rank runs its share of the one-process
    references (``REFERENCES``) on the global batch; then ``lostgan_steps``
    for the configurations ``names`` and ``special_steps``."""
    from layout2img_tpu_torch.parallel import mesh as data_mesh

    assert set(names) | set(FAMILIES) == REFERENCES[0] | REFERENCES[1]
    mesh = data_mesh.initialize("cpu")
    reductions(mesh, out_dir)
    mine = REFERENCES[mesh.rank]
    with data_mesh.use(data_mesh.world("cpu")):
        refs = {name: run_lostgan(*lostgan_state(name), global_batch())
                for name in names if name in mine}
        refs.update({f: run_special(f, special_batch(f)) for f in FAMILIES if f in mine})
    lostgan_steps(mesh, names, refs, out_dir)
    special_steps(mesh, refs, out_dir)
    data_mesh.shutdown()


def lostgan_steps(mesh, names: list[str], refs: dict, out_dir: str) -> None:
    """Both ranks run each configuration on their halves of the global
    batch, and the rank that holds its reference writes ``<name>.pt``:
    ``compare`` after each step."""
    from layout2img_tpu_torch.parallel import mesh as data_mesh

    mine = {k: mesh.rows(v) for k, v in global_batch().items()}
    for name in names:
        state, cfg = lostgan_state(name)
        data_mesh.replicate(mesh, state)
        steps = run_lostgan(state, cfg, mine)
        everyone = everyone_bits(mesh, steps)
        if name in refs:
            torch.save([compare(r, s, [e[t] for e in everyone])
                        for t, (r, s) in enumerate(zip(refs[name], steps))],
                       os.path.join(out_dir, f"{name}.pt"))


# ---- batch statistics and masked means under 2 ranks ----

def reductions(mesh, out_dir: str) -> None:
    """``batch_stats`` (alone and inside an ISLA norm) and
    ``masked_mean`` on the rank's half of a global input, and the gradient
    at that half of ``stats + masked mean + sum(norm output * cotangent)``.
    Summed over the ranks that is the gradient of ``W (stats + masked mean)
    + sum(...)`` over the whole input, which rank 0 also computes in one
    process."""
    from layout2img_tpu_torch.losses.gan import masked_mean
    from layout2img_tpu_torch.nn.norms import SpatialAdaptiveNorm, batch_stats
    from layout2img_tpu_torch.parallel import mesh as data_mesh
    from layout2img_tpu_torch.utils.convert import _init_

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 5, 6, 7, generator=g) * 2 + 0.5
    vectors = torch.randn(4, 3, 8, generator=g)
    mask = torch.rand(4, 3, 6, 7, generator=g)
    scores, valid = torch.randn(4, 3, generator=g), (torch.rand(4, 3, generator=g) > 0.4).float()
    cot = torch.randn(4, 5, 6, 7, generator=g)

    def run(scale, x, vectors, mask, scores, valid, cot):
        norm = SpatialAdaptiveNorm(5, 8).train()
        _init_(norm, torch.Generator().manual_seed(1))
        x, scores = x.clone().requires_grad_(True), scores.clone().requires_grad_(True)
        mean, var = batch_stats(x)
        out = norm(x, vectors, mask, relu=True)
        mm = masked_mean(scores, valid)
        loss = scale * ((mean * torch.arange(5.0)).sum() + var.sum() + 3.0 * mm) + (out * cot).sum()
        gx, gs = torch.autograd.grad(loss, [x, scores])
        bn = norm.batch_norm2d
        return {"mean": mean.detach(), "var": var.detach(), "out": out.detach(),
                "masked_mean": mm.detach(), "grad_x": gx, "grad_scores": gs,
                "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}

    out = {}
    if mesh.rank == 0:
        with data_mesh.use(data_mesh.world("cpu")):
            out["ref"] = run(2.0, x, vectors, mask, scores, valid, cot)
    out["rank"] = run(1.0, *(mesh.rows(t) for t in (x, vectors, mask, scores, valid, cot)))
    out["inception"] = _sharded_inception(mesh)
    torch.save(out, os.path.join(out_dir, f"reductions.{mesh.rank}.pt"))


class _TinyInception(torch.nn.Module):
    """(features, logits) of NCHW images, as ``eval/inception.py``'s net gives them."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.conv = torch.nn.Conv2d(3, 6, 3)
        self.fc = torch.nn.Linear(6, 5)

    def forward(self, x):
        f = self.conv(x).mean(dim=(2, 3))
        return f, self.fc(f)


def _sharded_inception(mesh) -> dict:
    """``run_inception_batches`` on chunks of 5 and 3 images (padded up to
    the 2 ranks), sharded and in one process."""
    from layout2img_tpu_torch.eval.metrics import run_inception_batches

    net = _TinyInception()
    images = np.random.default_rng(1).uniform(-1, 1, (8, 9, 9, 3)).astype(np.float32)
    chunks = [images[:5], images[5:]]
    return {"sharded": [torch.from_numpy(a) for a in run_inception_batches(net, chunks, mesh=mesh)],
            "one": [torch.from_numpy(a) for a in run_inception_batches(net, chunks)]}


# ---- cli.train under 2 ranks ----

def cli_rank(rank: int, argv: list[str], out_dir: str) -> None:
    """Rank program: ``cli.train.main(argv)``; its exit code goes to
    ``exit.<rank>`` (0 when it returns)."""
    from layout2img_tpu_torch.cli import train

    code = 0
    try:
        train.main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    with open(os.path.join(out_dir, f"exit.{rank}"), "w") as f:
        f.write(str(code))


# ---- the special families' steps under 2 ranks ----

def special_state(family: str):
    """(state, step factory) of Ours-ED (``bgfg``) or layout2im, from seeded draws."""
    from layout2img_tpu_torch.train.state import TrainConfig
    from layout2img_tpu_torch.train.step_bgfg import create_bgfg_state, make_bgfg_train_step
    from layout2img_tpu_torch.train.step_layout2im import (Layout2ImConfig,
                                                           create_layout2im_state,
                                                           make_layout2im_train_step)
    from layout2img_tpu_torch.utils import convert

    if family == "bgfg":
        cfg = TrainConfig(use_vgg_loss=False)
        gen = convert.init_bgfg_generator(0, 91, 93, device="cpu", ch=CH)
        disc = convert.init_discriminator(1, 184, preset="d64", device="cpu", ch=CH)
        state = create_bgfg_state(gen, disc, cfg)
        return state, lambda: make_bgfg_train_step(state, cfg)
    cfg = Layout2ImConfig()
    gen = convert.init_layout2im_generator(0, NC, fusion="transformer", device="cpu")
    state = create_layout2im_state(gen, *convert.init_layout2im_discriminators(
        1, NC, conv_dim=CH, device="cpu"), cfg)
    return state, lambda: make_layout2im_train_step(state, cfg)


def special_batch(family: str) -> dict[str, torch.Tensor]:
    from layout2img_tpu_torch.data.coco import split_fg_bg_batch
    from layout2img_tpu_torch.data.synthetic import synthetic_batch

    batch = synthetic_batch(np.random.default_rng(4), 2 * B_RANK, 64, O,
                            184 if family == "bgfg" else NC, min_objects=2)
    if family == "bgfg":
        batch = {**batch, **split_fg_bg_batch(batch)}
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return {k: v.long() if k.startswith("labels") else v for k, v in out.items()}


def run_special(family: str, batch: dict) -> list[dict]:
    """One step (dropout live, latents from ``Generator().manual_seed(5)``,
    the global generator seeded 11); its metrics and state."""
    state, make = special_state(family)
    torch.manual_seed(11)
    metrics = make()(batch, torch.Generator().manual_seed(5))
    return [{"metrics": {k: float(v) for k, v in metrics.items()}, "state": state_tensors(state)}]


def special_steps(mesh, refs: dict, out_dir: str) -> None:
    """Both ranks run each special family on their halves of its batch; the
    rank that holds its reference writes ``<family>.pt`` (``compare``)."""
    for family in FAMILIES:
        got = run_special(family, {k: mesh.rows(v) for k, v in special_batch(family).items()})
        everyone = everyone_bits(mesh, got)
        if family in refs:
            torch.save([compare(refs[family][0], got[0], [e[0] for e in everyone])],
                       os.path.join(out_dir, f"{family}.pt"))


# ---- the LostGAN step under 2 ranks from given weights and latents ----

def given_rank(rank: int, inputs: str, out_dir: str) -> None:
    """Rank program: the flagship (ch=4, 64 px) from the state dicts in
    ``inputs`` (``g_sd``, ``d_sd``, ``batch``, ``z``, ``z_im`` for the
    global batch), one f32 step with dropout off on the rank's rows of the
    batch and latents; writes the networks' state dicts and the metrics to
    ``given.<rank>.pt``."""
    from layout2img_tpu_torch.models.discriminators import make_discriminator
    from layout2img_tpu_torch.models.generators import make_generator
    from layout2img_tpu_torch.parallel import mesh as data_mesh
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step

    mesh = data_mesh.initialize("cpu")
    given = torch.load(inputs)
    gen = make_generator("ours_d_context128", NC, device="cpu", ch=CH, image_size=IMG,
                         num_mask_classes=NC)
    gen.load_state_dict(given["g_sd"], strict=True)
    disc = make_discriminator("d128_app", NC, device="cpu", ch=CH, image_size=IMG)
    disc.load_state_dict(given["d_sd"], strict=True)
    cfg = TrainConfig(use_vgg_loss=False)
    state = create_train_state(gen, disc, cfg)
    step = make_train_step(state, cfg, deterministic=True)
    metrics = step.with_latents({k: mesh.rows(v) for k, v in given["batch"].items()},
                                mesh.rows(given["z"]), mesh.rows(given["z_im"]))
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "generator": gen.state_dict(), "discriminator": disc.state_dict()},
               os.path.join(out_dir, f"given.{rank}.pt"))
    data_mesh.shutdown()
