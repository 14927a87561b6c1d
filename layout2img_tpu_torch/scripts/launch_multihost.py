"""Multi-process training launcher (counterpart of ``scripts/launch_multihost.py``).

One process runs per GPU; ``parallel/mesh.py`` joins them into one process
group and the train step is the one-process step at the global batch. The
usual launch is torchrun, which sets the variables the mesh reads
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); ``cli.train`` needs no launcher of its own
then:

    torchrun --nproc_per_node=N -m layout2img_tpu_torch.cli.train \\
        --model context_app_v2 --dataset coco --batch_size 16 ...

This script does the same for one process started by another launcher:
under SLURM (one task per GPU) it maps ``SLURM_PROCID``, ``SLURM_NTASKS``,
``SLURM_LOCALID`` and ``SLURM_NTASKS_PER_NODE`` onto those variables, with the
master from ``--coordinator_address`` (host:port; default
``localhost:29500``), or they are given by flag:

    srun --ntasks-per-node=8 python -m layout2img_tpu_torch.scripts.launch_multihost \\
        --coordinator_address node0:29500 --model context_app_v2 ...
    python -m layout2img_tpu_torch.scripts.launch_multihost --num_processes 2 \\
        --process_id 0 --device cpu --model context_app_v2 ...

Every flag after the launcher's own goes to ``cli.train``. ``--batch_size`` is
the per-process batch; the global batch is batch_size * the process count.
"""

from __future__ import annotations

import argparse
import os


def rank_environment(args, env: dict[str, str]) -> dict[str, str]:
    """The torchrun variables for this process: the launcher's flags first,
    then torchrun's own variables, then SLURM's."""
    out = {}
    host, _, port = (args.coordinator_address or env.get("MASTER_ADDR", "localhost")).partition(":")
    out["MASTER_ADDR"] = host
    out["MASTER_PORT"] = port or env.get("MASTER_PORT", "29500")
    for name, flag, slurm in (("RANK", args.process_id, "SLURM_PROCID"),
                              ("WORLD_SIZE", args.num_processes, "SLURM_NTASKS"),
                              ("LOCAL_RANK", None, "SLURM_LOCALID")):
        value = flag if flag is not None else env.get(name, env.get(slurm))
        if value is not None:
            out[name] = str(value)
    if "WORLD_SIZE" not in out or "RANK" not in out:
        raise SystemExit("no rank: pass --num_processes and --process_id, or run under torchrun "
                         "or SLURM")
    out.setdefault("LOCAL_RANK", out["RANK"])
    per_node = env.get("LOCAL_WORLD_SIZE", env.get("SLURM_NTASKS_PER_NODE", "").split("(")[0])
    out["LOCAL_WORLD_SIZE"] = per_node or out["WORLD_SIZE"]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0 (default: MASTER_ADDR/MASTER_PORT or localhost:29500)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    args, train_argv = p.parse_known_args(argv)
    os.environ.update(rank_environment(args, dict(os.environ)))

    from layout2img_tpu_torch.cli import train

    return train.main(train_argv)


if __name__ == "__main__":
    main()
