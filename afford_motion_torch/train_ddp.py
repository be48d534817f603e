"""Data-parallel training entry of the port (counterpart of the root
``train_ddp.py``): one process per card, launched by ``torchrun``,

    torchrun --nproc_per_node <cards> -m afford_motion_torch.train_ddp <train.py overrides>

(``python -m torch.distributed.run`` is the same launcher). Each process
trains on ``cuda:$LOCAL_RANK`` (a ``device=`` override names another) in one
NCCL process group, set up before :func:`afford_motion_torch.train.entry.train`
and torn down after it; a caller that wants another backend or rendezvous
opens ``parallel.session`` first, and this entry trains inside it.
``task.train.batch_size`` is the global batch, which the number of processes
must divide; rank 0 writes the checkpoints, logs and board, in rank 0's
experiment directory (``exp_dir`` resolves the time on each rank, so rank 0's
is handed to the others). Without a launcher (no ``RANK`` / ``WORLD_SIZE``)
it is the one-process entry. See ``train/loop.py`` for what the run shares
between the ranks.
"""
from __future__ import annotations

import sys
from typing import Any, Dict

from .parallel import launched, session
from .train.entry import run
from .utils.config import load_config
from .utils.device import resolve_device

# the configuration's paths that hold the time the config was loaded
RUN_DIRS = ("exp_dir", "log_dir", "ckpt_dir", "eval_dir")


def main(argv=None, device=None) -> Dict[str, Any]:
    """Train this process's share with the given overrides; returns its
    summary."""
    cfg = load_config("configs", argv if argv is not None else sys.argv[1:])
    dev = resolve_device(cfg, device)
    if not launched():
        return run(cfg, dev)
    with session(dev) as dp:
        for key, value in dp.broadcast_object({k: cfg[k] for k in RUN_DIRS}).items():
            cfg[key] = value
        return run(cfg, dev)


if __name__ == "__main__":
    main()
