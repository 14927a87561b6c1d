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
    ``exit.<rank>`` (0 when it returns), and the message of an exit with
    one to ``message.<rank>``."""
    from layout2img_tpu_torch.cli import train

    code = 0
    try:
        train.main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
        if not isinstance(e.code, int):
            with open(os.path.join(out_dir, f"message.{rank}"), "w") as f:
                f.write(str(e.code))
    with open(os.path.join(out_dir, f"exit.{rank}"), "w") as f:
        f.write(str(code))


# ---- cli.sample and cli.evaluate under 2 ranks ----

def run_cli_calls(calls: list, out_dir: str, tag) -> None:
    """Each (name, cli module, argv) of ``calls`` in turn, through
    ``layout2img_tpu_torch.cli.<module>.main(argv)``; what it prints goes to
    ``<name>.<tag>.out`` in ``out_dir``."""
    import contextlib
    import importlib

    for name, module, argv in calls:
        main = importlib.import_module(f"layout2img_tpu_torch.cli.{module}").main
        with open(os.path.join(out_dir, f"{name}.{tag}.out"), "w") as f, \
                contextlib.redirect_stdout(f):
            main(argv)


def cli_calls_rank(rank: int, calls: list, out_dir: str) -> None:
    """Rank program: ``run_cli_calls`` tagged with the rank, in one process
    group that every call finds formed (``parallel/mesh.py::launched``)."""
    from layout2img_tpu_torch.parallel import mesh as data_mesh

    data_mesh.initialize("cpu")
    try:
        run_cli_calls(calls, out_dir, rank)
    finally:
        data_mesh.shutdown()


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


# ---- the 2-D (data, model) mesh ----

# name: (mode, TrainConfig fields, steps); the one-process references run the
# same configuration on the whole global batch
MESH2D_CONFIGS = {
    "tensor_ema": ("tensor", dict(ema_decay=0.999), 2),
    "tensor_remat": ("tensor", dict(remat="gd"), 1),
    "spatial_vgg": ("spatial", dict(use_vgg_loss=True), 2),
    "spatial_mixed": ("spatial", dict(mixed_precision=True), 1),
}
MESH2D_2X2 = ("tensor_ema", "spatial_vgg")  # one step each on 2 data groups x M = 2
B_2D = 4  # the global batch of both meshes


def mesh2d_state(name: str):
    """(state, config, VGG loss or None) of ``MESH2D_CONFIGS[name]`` from seeded draws."""
    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator, init_vgg

    _, fields, _ = MESH2D_CONFIGS[name]
    gen = init_generator(0, NC, preset="ours_d_context128", device="cpu", ch=CH, image_size=IMG)
    disc = init_discriminator(1, NC, preset="d128_app", device="cpu", ch=CH, image_size=IMG)
    cfg = TrainConfig(**{"use_vgg_loss": False, **fields})
    vgg = VGGLoss(init_vgg(2, device="cpu")) if cfg.use_vgg_loss else None
    return create_train_state(gen, disc, cfg), cfg, vgg


def run_mesh2d(state, cfg, vgg, batch: dict, steps: int, mesh=None) -> list[dict]:
    """``run_lostgan`` with the VGG loss, the state gathered whole after each
    step (``train/checkpoint.py::whole_state_dict``); on a ``mesh``, also
    whether each rank then holds the bits it should (``check_replicated``:
    None, or its error)."""
    from layout2img_tpu_torch.parallel import mesh as data_mesh
    from layout2img_tpu_torch.train.checkpoint import whole_state_dict
    from layout2img_tpu_torch.train.step import make_train_step

    torch.manual_seed(11)
    rng = torch.Generator().manual_seed(5)
    step = make_train_step(state, cfg, vgg_loss=vgg)
    out = []
    for _ in range(steps):
        metrics = {k: float(v) for k, v in step(batch, rng).items()}
        whole = data_mesh.flat_tensors(whole_state_dict(state))
        differ = None
        if mesh is not None:
            try:
                data_mesh.check_replicated(mesh, state)
            except RuntimeError as e:
                differ = str(e)
        out.append({"metrics": metrics, "state": {k: t.detach().clone() for k, t in whole.items()},
                    "differ": differ})
    return out


def mesh2d_steps(name: str, one_step: bool) -> int:
    return 1 if one_step else MESH2D_CONFIGS[name][2]


def mesh2d_references(names, one_step: bool) -> dict:
    """The one-process runs of ``names`` on the global batch."""
    from layout2img_tpu_torch.parallel import mesh as data_mesh

    with data_mesh.use(data_mesh.world("cpu")):
        return {n: run_mesh2d(*mesh2d_state(n), global_batch(b=B_2D), mesh2d_steps(n, one_step))
                for n in names}


def shard_layout(state, mesh) -> dict:
    """Tensor mode: the leaves held whole where they could be cut
    (``wrong``: a shardable weight whose output features divide by M, or a
    shard that is not 1/M of it), the Adam moments and EMA whose shapes are
    not their parameter's, and the parameters of rank >= 2 outside the
    shardable layers."""
    from layout2img_tpu_torch.parallel import mesh as data_mesh

    wrong, moments, outside = [], [], []
    for key, net, opt in (("generator", state.generator, state.g_opt),
                          ("discriminator", state.discriminator, state.d_opt)):
        covered = set()
        for prefix, m in net.named_modules():
            if getattr(m, "TP_PARAM", None) is None:
                continue
            name = f"{prefix}.{m.TP_PARAM}" if prefix else m.TP_PARAM
            covered.add(name)
            local = getattr(m, m.TP_PARAM)
            whole = data_mesh.gather_shard(local, m.TP_DIM) if m.tp_dim is not None else local
            divides = whole.shape[m.TP_DIM] % mesh.model == 0
            if divides != (m.tp_dim is not None) or (divides and local.numel() * mesh.model
                                                     != whole.numel()):
                wrong.append(f"{key}.{name}")
        for i, (name, p) in enumerate(net.named_parameters()):
            st = opt.state.get(p, {})
            if any(st[k].shape != p.shape for k in ("exp_avg", "exp_avg_sq") if k in st):
                moments.append(f"{key}.{name}")
            if key == "generator" and state.ema is not None and state.ema[name].shape != p.shape:
                moments.append(f"ema.{name}")
            if p.ndim >= 2 and name not in covered:
                outside.append(f"{key}.{name}")
    return {"wrong": wrong, "moments": moments, "outside": outside}


def mesh2d_units(mesh) -> dict:
    """The 2-D mesh's pieces on a 1 x 2 mesh, each against the one-process
    computation on the whole input, with seeded inputs alike on both ranks.
    Each entry is (got, want) pairs; gradients of whole inputs are the
    ranks' parts, which sum to M times the gradient (so ``/ M`` of the sum)."""
    import dataclasses

    import torch.distributed as dist

    from layout2img_tpu_torch.nn.gcn import GraphConvolution
    from layout2img_tpu_torch.nn.layers import Conv2d, Embedding, Linear
    from layout2img_tpu_torch.nn.norms import batch_stats
    from layout2img_tpu_torch.nn.spectral import SNConv, SNDense, SNEmbed
    from layout2img_tpu_torch.ops.isla import isla_norm
    from layout2img_tpu_torch.ops.roi import roi_align
    from layout2img_tpu_torch.parallel import mesh as data_mesh
    from layout2img_tpu_torch.utils.convert import _init_

    m = mesh.model
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 8, 5, generator=g)
    cot = torch.randn(2, 6, 8, 5, generator=g)

    def parts_sum(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=mesh.model_group)
        return t / m

    out = {}
    spatial = dataclasses.replace(mesh, mode="spatial")
    tensor = dataclasses.replace(mesh, mode="tensor")

    # a conv with halos, forward and both gradients
    conv = SNConv(6, 4, 3)
    _init_(conv, torch.Generator().manual_seed(1))
    conv.eval()
    xr = x.clone().requires_grad_(True)
    with data_mesh.use(data_mesh.world("cpu")):
        y = conv(xr)
        want = [y.detach(), *torch.autograd.grad((y * cot[:, :4]).sum(), [xr, conv.weight_orig])]
    with data_mesh.use(spatial), data_mesh.row_shards(True):
        xs = x.clone().requires_grad_(True)
        whole = data_mesh.join_rows(conv(data_mesh.split_rows(xs)))
        dx, dw = torch.autograd.grad((whole * cot[:, :4]).sum(), [xs, conv.weight_orig])
    out["halo_conv"] = list(zip([whole.detach(), parts_sum(dx), parts_sum(dw)], want))

    # column-parallel layers (training mode: one sharded power iteration)
    idx = torch.randint(0, 7, (3, 4), generator=g)
    adj = torch.softmax(torch.randn(2, 6, 6, generator=g), dim=-1)
    layers = {"sn_conv": (lambda: SNConv(6, 4, 3), x, ()),
              "sn_dense": (lambda: SNDense(5, 6), x, ()),
              "sn_embed": (lambda: SNEmbed(7, 6), idx, ()),
              "conv": (lambda: Conv2d(6, 4, 3, padding=1), x, ()),
              "dense": (lambda: Linear(5, 6), x, ()),
              "embed": (lambda: Embedding(7, 6), idx, ()),
              "gcn": (lambda: GraphConvolution(5, 4), x[:, 0, :6], (adj,))}
    for name, (make, inp, rest) in layers.items():
        pair = []
        for mode in ("one", "tensor"):
            layer = make()
            _init_(layer, torch.Generator().manual_seed(2))
            layer.train()
            with data_mesh.use(data_mesh.world("cpu") if mode == "one" else tensor):
                if mode == "tensor":
                    data_mesh.shard_parameters(layer, tensor)
                leaf = inp.clone().requires_grad_(inp.is_floating_point())
                y = layer(leaf, *rest)
                w = getattr(layer, layer.TP_PARAM)
                grads = torch.autograd.grad((y * torch.ones_like(y).cumsum(-1)).sum(),
                                            [w] + ([leaf] if leaf.requires_grad else []))
                if mode == "tensor":
                    grads = (data_mesh.gather_shard(grads[0], layer.TP_DIM), *grads[1:])
                u = getattr(layer, "weight_u", torch.zeros(0))
                pair.append([y.detach(), *grads, u.clone()])
        out[f"tp_{name}"] = list(zip(pair[1], pair[0]))

    # batch statistics: over the data axis in tensor mode (here one group),
    # over every rank on row shards
    with data_mesh.use(data_mesh.world("cpu")):
        want = batch_stats(x)
    with data_mesh.use(tensor):
        got_t = batch_stats(x)
    with data_mesh.use(spatial), data_mesh.row_shards(True):
        got_s = batch_stats(data_mesh.split_rows(x))
    out["batch_stats"] = list(zip((*got_t, *got_s), (*want, *want)))

    # the ISLA norm on row windows with global statistics: rows, and the
    # gradients of x, the mask and gamma/beta
    mask = torch.rand(2, 3, 5, 4, generator=g)
    gamma, beta = torch.randn(2, 3, 6, generator=g), torch.randn(2, 3, 6, generator=g)

    def norm(xx, mm, gg, bb):
        mean, var = batch_stats(xx)
        row0, full_h = data_mesh.row_window(xx.shape[-2])
        return isla_norm(xx, mean, var, 1e-5, mm, gg, bb, relu=True, row0=row0, full_h=full_h)

    leaves = [t.clone().requires_grad_(True) for t in (x, mask, gamma, beta)]
    with data_mesh.use(data_mesh.world("cpu")):
        y = norm(*leaves)
        want = [y.detach(), *torch.autograd.grad((y * cot).sum(), leaves)]
    leaves = [t.clone().requires_grad_(True) for t in (x, mask, gamma, beta)]
    with data_mesh.use(spatial), data_mesh.row_shards(True):
        y = norm(data_mesh.split_rows(leaves[0]), *leaves[1:])
        whole = data_mesh.join_rows(y)
        got = [whole.detach(), *(parts_sum(t) for t in torch.autograd.grad((whole * cot).sum(),
                                                                          leaves))]
    out["isla_rows"] = list(zip(got, want))

    # RoIAlign summed over the model group's partial crops
    feats = torch.randn(2, 3, 16, 16, generator=g)
    boxes = torch.tensor([[[1.0, 2.0, 9.0, 15.0], [4.0, 0.0, 16.0, 7.5]],
                          [[0.0, 0.0, 16.0, 16.0], [7.0, 7.0, 8.0, 8.0]]]) * 4
    with data_mesh.use(data_mesh.world("cpu")):
        want = roi_align(feats, boxes, 8, 0.25)
    with data_mesh.use(spatial), data_mesh.row_shards(True):
        got = roi_align(data_mesh.split_rows(feats), boxes, 8, 0.25, rows=True)
    out["roi_rows"] = [(got, want)]
    return out


def mesh2d_rank(rank: int, model_parallel: int, names: list[str], with_units: bool,
                out_dir: str) -> None:
    """Rank program of ``tests/test_torch_port_mesh2d.py``: the units (on a
    1 x 2 mesh), the one-process references of ``names`` (split over the
    ranks), then each configuration of ``names`` on the (W / M, M) mesh, on
    the data group's rows of the global batch; the ranks of model index 0
    write ``<name>.<data group>.pt``: per step ``compare`` against its
    reference (the state gathered whole) and whether every rank holds the
    bits it should (``check_replicated``), and the tensor-mode shard layout."""
    import torch.distributed as dist

    from layout2img_tpu_torch.parallel import mesh as data_mesh

    mesh = data_mesh.initialize("cpu")
    if with_units:
        units = mesh2d_units(data_mesh.make_mesh_2d(mesh, 2, "tensor"))
        if rank == 0:
            torch.save(units, os.path.join(out_dir, "units.pt"))
    one_step = model_parallel < mesh.world
    refs = mesh2d_references([n for i, n in enumerate(names) if i % mesh.world == rank], one_step)
    everyone: list = [None] * mesh.world
    dist.all_gather_object(everyone, refs)
    refs = {k: v for r in everyone for k, v in r.items()}
    for name in names:
        with data_mesh.use(mesh):  # the configuration's mesh is current inside
            _mesh2d_config(name, data_mesh.make_mesh_2d(mesh, model_parallel,
                                                        MESH2D_CONFIGS[name][0]), refs[name],
                           one_step, out_dir)
    data_mesh.shutdown()


def _mesh2d_config(name: str, two, refs: list, one_step: bool, out_dir: str) -> None:
    """One configuration of ``mesh2d_rank`` on the 2-D mesh ``two``; the
    optimizers and EMA are rebuilt on the shards in tensor mode."""
    from layout2img_tpu_torch.parallel import mesh as data_mesh
    from layout2img_tpu_torch.train.checkpoint import sharded_leaves
    from layout2img_tpu_torch.train.state import create_train_state

    mode = two.mode
    state, cfg, vgg = mesh2d_state(name)
    if mode == "tensor":
        data_mesh.shard_parameters(state.generator, two)
        data_mesh.shard_parameters(state.discriminator, two)
        state = create_train_state(state.generator, state.discriminator, cfg)
    steps_out = run_mesh2d(state, cfg, vgg, {k: two.rows(v) for k, v in
                                             global_batch(b=B_2D).items()},
                           mesh2d_steps(name, one_step), two)
    layout = shard_layout(state, two) if mode == "tensor" else None
    n_sharded = len(sharded_leaves(state))
    if two.model_index == 0:
        torch.save({"steps": [compare(r, s, [[], []]) for r, s in zip(refs, steps_out)],
                    "ranks_differ": [s["differ"] for s in steps_out], "layout": layout,
                    "n_sharded": n_sharded,
                    "shapes": [{k: tuple(v.shape) for k, v in s["state"].items()}
                               for s in steps_out],
                    "ref_shapes": [{k: tuple(v.shape) for k, v in r["state"].items()}
                                   for r in refs]},
                   os.path.join(out_dir, f"{name}.{two.data_index}.pt"))


def given2d_rank(rank: int, inputs: str, out_dir: str) -> None:
    """Rank program: ``given_rank``'s step on a 1 x 2 mesh in tensor and then
    in spatial mode, from the same state dicts and latents, both ranks on the
    whole batch; rank 0 writes each mode's networks gathered whole and its
    metrics to ``given2d.<mode>.pt``."""
    from layout2img_tpu_torch.parallel import mesh as data_mesh

    mesh = data_mesh.initialize("cpu")
    given = torch.load(inputs)
    for mode in ("tensor", "spatial"):
        with data_mesh.use(mesh):  # each mode's mesh is current inside
            _given2d_step(rank, given, data_mesh.make_mesh_2d(mesh, 2, mode), out_dir)
    data_mesh.shutdown()


def _given2d_step(rank: int, given: dict, two, out_dir: str) -> None:
    """One mode of ``given2d_rank`` on the 2-D mesh ``two``."""
    from layout2img_tpu_torch.models.discriminators import make_discriminator
    from layout2img_tpu_torch.models.generators import make_generator
    from layout2img_tpu_torch.parallel import mesh as data_mesh
    from layout2img_tpu_torch.train.checkpoint import whole_tensors
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step

    mode = two.mode
    gen = make_generator("ours_d_context128", NC, device="cpu", ch=CH, image_size=IMG,
                         num_mask_classes=NC)
    gen.load_state_dict(given["g_sd"], strict=True)
    disc = make_discriminator("d128_app", NC, device="cpu", ch=CH, image_size=IMG)
    disc.load_state_dict(given["d_sd"], strict=True)
    dims = {}
    if mode == "tensor":
        dims = {"generator": data_mesh.shard_parameters(gen, two),
                "discriminator": data_mesh.shard_parameters(disc, two)}
    cfg = TrainConfig(use_vgg_loss=False)
    state = create_train_state(gen, disc, cfg)
    step = make_train_step(state, cfg, deterministic=True)
    metrics = step.with_latents(given["batch"], given["z"], given["z_im"])
    nets = {k: whole_tensors(net.state_dict(), dims.get(k, {}))
            for k, net in (("generator", gen), ("discriminator", disc))}
    if rank == 0:
        torch.save({"metrics": {k: float(v) for k, v in metrics.items()}, **nets},
                   os.path.join(out_dir, f"given2d.{mode}.pt"))


# ---- the collectives' spans under 2 ranks ----

def tracing_rank(rank: int, out_dir: str) -> None:
    """Rank program of ``tests/test_torch_port_tracing.py``: one mixed LostGAN
    step on this rank's rows with spans on; writes ``<rank>.json``: the
    number of ``mesh.all_reduce`` spans per ``kind``."""
    import json

    from layout2img_tpu_torch.parallel import mesh as data_mesh
    from layout2img_tpu_torch.utils import tracing

    mesh = data_mesh.initialize("cpu")
    state, cfg = lostgan_state("mixed")
    tracing.enable(True)
    try:
        run_lostgan(state, cfg, {k: mesh.rows(v) for k, v in global_batch().items()}, steps=1)
    finally:
        tracing.enable(None)
    kinds: dict[str, int] = {}
    for r in tracing.records():
        if r.name == "mesh.all_reduce":
            kinds[r.attrs["kind"]] = kinds.get(r.attrs["kind"], 0) + 1
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(kinds, f)
    data_mesh.shutdown()
