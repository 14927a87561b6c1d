"""Checkpoints and resume (counterpart of ``layout2img_tpu/train/checkpoint.py``).

A checkpoint is the whole train state, one ``torch.save`` file per step,
``<directory>/<step>/state.pt``: the step, both networks' ``state_dict()``
(parameters, the SN ``weight_u``/``weight_v`` vectors and the BN running
statistics: the JAX package's ``g_state`` and ``d_state``), both Adams'
``state_dict()`` and, when there is one, the generator's EMA. The masters
are f32 under mixed precision too (the bf16 copies live only inside the
step). Each file is written to a temporary name and ``os.replace``d into
place, so a reader sees a whole checkpoint or none, and the ``keep`` newest
steps are kept.

``AsyncSaver`` snapshots the state on the device and writes it in a
background thread (one process only).

Under a data-parallel mesh (``parallel/mesh.py``) the state is replicated:
``save`` is called on every rank, and rank 0 writes between two barriers;
``restore`` reads on every rank and checks that the ranks restored the same
step. In the 2-D mesh's tensor mode the ranks of a model group hold shards
(``sharded_leaves``): ``save`` gathers them whole first, so the file is the
one-process format, and ``restore`` cuts each rank's shards from it. A
checkpoint so moves between one process, the 1-D mesh and either 2-D mode.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading

import numpy as np
import torch

from layout2img_tpu_torch.parallel import mesh as data_mesh
from layout2img_tpu_torch.train.ema import ema_init
from layout2img_tpu_torch.train.state import GANTrainState

FILE = "state.pt"


def state_dict(state: GANTrainState) -> dict:
    """The checkpoint's content, as references to the live tensors."""
    out = {"step": int(state.step), "generator": state.generator.state_dict(),
           "discriminator": state.discriminator.state_dict(), "g_opt": state.g_opt.state_dict(),
           "d_opt": state.d_opt.state_dict()}
    if state.ema is not None:
        out["ema"] = dict(state.ema)
    return out


def sharded_leaves(state: GANTrainState) -> dict[str, int]:
    """{name: sharded dim} of the tensor-mode shards among the state's
    tensors, named as ``parallel/mesh.py::state_tensors`` names them: the
    sharded parameters, their Adam moments and their EMA (empty when nothing
    is sharded)."""
    out = {}
    for key, net, opt in (("generator", state.generator, "g_opt"),
                          ("discriminator", state.discriminator, "d_opt")):
        dims = data_mesh.shard_dims(net)
        out.update({f"{key}.{name}": d for name, d in dims.items()})
        for i, (name, _) in enumerate(net.named_parameters()):
            if name in dims:
                out[f"{opt}.state.{i}.exp_avg"] = out[f"{opt}.state.{i}.exp_avg_sq"] = dims[name]
                if key == "generator":
                    out[f"ema.{name}"] = dims[name]
    return out


def _map_named(tree, fn, prefix: str = ""):
    """``fn(name, tensor)`` for each tensor of nested dicts and lists, named
    by dotted path as ``parallel/mesh.py::flat_tensors`` names them."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, f"{prefix}.{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(v, fn, f"{prefix}.{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return tree


def whole_tensors(tree, dims: dict[str, int]):
    """``tree`` with the tensors that ``dims`` names gathered whole from the
    model group's shards (every rank of the group calls it)."""
    if not dims:
        return tree
    return _map_named(tree, lambda k, t: data_mesh.gather_shard(t, dims[k]) if k in dims else t)


def whole_state_dict(state: GANTrainState) -> dict:
    """``state_dict`` in the one-process format: tensor-mode shards gathered."""
    return whole_tensors(state_dict(state), sharded_leaves(state))


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        """The steps with a complete checkpoint, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: GANTrainState) -> None:
        mesh = data_mesh.current()
        content = whole_state_dict(state)
        mesh.barrier()
        if mesh.rank == 0:
            self.write(content, int(state.step))
        mesh.barrier()

    def write(self, content: dict, step: int) -> None:
        """Write a checkpoint's content (``state_dict``'s form) as ``step``,
        then drop all but the ``keep`` newest steps."""
        step_dir = os.path.join(self.directory, str(step))
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, f"{FILE}.{os.getpid()}.{threading.get_ident()}.tmp")
        torch.save(content, tmp)
        os.replace(tmp, os.path.join(step_dir, FILE))
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def wait(self) -> None:
        """Nothing in flight: saves here are synchronous."""

    def read(self, step: int | None = None) -> dict:
        """A checkpoint's content on the CPU (default: the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, state: GANTrainState, step: int | None = None) -> GANTrainState:
        """Load a checkpoint (default: the latest) into an initialized state,
        in place, and return it. A checkpoint's EMA is restored even when
        the state has none (the sampler then gets it); a state that wants an
        EMA from a checkpoint without one starts it from a copy of the
        restored generator's parameters. Any other mismatch, such as another
        ``--ch``, raises as ``load_state_dict`` raises."""
        ck = self.read(step)
        dims = sharded_leaves(state)
        if dims:
            ck = _map_named(ck, lambda k, t: data_mesh.own_shard(t, dims[k]) if k in dims else t)
        state.generator.load_state_dict(ck["generator"], strict=True)
        state.discriminator.load_state_dict(ck["discriminator"], strict=True)
        state.g_opt.load_state_dict(ck["g_opt"])
        state.d_opt.load_state_dict(ck["d_opt"])
        state.step = int(ck["step"])
        steps = data_mesh.current().gather_rows(np.array([state.step], np.int64))
        if (steps != state.step).any():
            raise RuntimeError(f"the ranks restored different steps: {steps.tolist()}")
        if "ema" in ck:
            params = dict(state.generator.named_parameters())
            if set(ck["ema"]) != set(params):
                raise RuntimeError(f"the checkpoint's EMA does not fit the generator: "
                                   f"{sorted(set(ck['ema']) ^ set(params))[:5]}")
            state.ema = {k: v.to(device=params[k].device, dtype=params[k].dtype)
                         for k, v in ck["ema"].items()}
        elif state.ema is not None:
            state.ema = ema_init(state.generator)
        return state


class AsyncSaver:
    """Non-blocking saves around a :class:`CheckpointManager`.

    The optimizers update the parameters in place, so the snapshot must be
    taken before the next step is enqueued: ``save`` clones every tensor of
    the state on the device, on the current stream (where the next step's
    kernels queue behind the copies), and records an event. A background
    thread waits for that event, copies the snapshot to the host on a side
    stream and writes it. One save is in flight at a time; a failed save
    is logged at the next ``save`` and raised by ``wait``.
    """

    def __init__(self, mgr: CheckpointManager):
        self._mgr = mgr
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def save(self, state: GANTrainState) -> None:
        self._join()
        if self._err is not None:
            logging.getLogger(__name__).warning(
                "previous async checkpoint save failed; attempting the next save anyway: %r",
                self._err)
            self._err = None
        step = int(state.step)
        with torch.no_grad():
            snap = _map_tensors(state_dict(state), lambda t: t.detach().clone())
        device = next(state.generator.parameters()).device
        ready = side = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
            side = torch.cuda.Stream(device)

        def work():
            try:
                content = snap
                if side is not None:
                    with torch.cuda.stream(side):
                        side.wait_event(ready)
                        content = _map_tensors(snap, lambda t: t.to("cpu"))
                self._mgr.write(content, step)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._err = e

        self._thread = threading.Thread(target=work, name="ckpt-save", daemon=True)
        self._thread.start()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self) -> None:
        self._join()
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint save failed") from err

    def latest_step(self) -> int | None:
        return self._mgr.latest_step()

    def read(self, step: int | None = None) -> dict:
        self.wait()
        return self._mgr.read(step)
