"""Logging + scalar boards (reference: utils/io.py:18-151).

loguru isn't available; a thin stdlib-logging setup provides the same
surface (console + per-experiment runtime.log). ``Board`` is the same
singleton scalar-writer wrapping TensorBoard (torch's SummaryWriter, which
works on CPU) or a JSONL fallback when tensorboard isn't importable.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

_LOGGER_NAME = "afford_motion_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)s | %(message)s", "%Y-%m-%d %H:%M:%S"))
        logger.addHandler(h)
        logger.propagate = False
    return logger


def add_file_handler(path: str) -> None:
    """Mirror the reference's per-experiment runtime.log (train.py:67)."""
    logger = get_logger()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    for h in logger.handlers:
        if isinstance(h, logging.FileHandler) and h.baseFilename == str(Path(path).resolve()):
            return
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(
        "%(asctime)s | %(levelname)s | %(message)s", "%Y-%m-%d %H:%M:%S"))
    logger.addHandler(fh)


def time_str() -> str:
    return time.strftime("%Y-%m-%d_%H-%M-%S")


def mkdir_if_not_exists(path: str) -> str:
    Path(path).mkdir(parents=True, exist_ok=True)
    return path


class _JsonlBoard:
    def __init__(self, log_dir: str):
        mkdir_if_not_exists(log_dir)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class _WandbBoard:
    """Offline-mode WandB writer (reference: utils/io.py:61-91). Runs are
    written under <log_dir>/wandb for a later `wandb sync`; online mode is
    never attempted."""

    def __init__(self, log_dir: str, project: str = "afford-motion-torch",
                 name: Optional[str] = None, **kwargs):
        import wandb

        os.environ.setdefault("WANDB_MODE", "offline")
        self._run = wandb.init(
            project=project, name=name, dir=log_dir, mode="offline",
        )

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._run.log({tag: float(value)}, step=int(step))

    def close(self) -> None:
        self._run.finish()


class Board:
    """Singleton scalar board (reference: utils/io.py:122-151)."""

    _instance: Optional["Board"] = None

    def __new__(cls) -> "Board":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._writer = None
        return cls._instance

    def create_board(self, platform: str = "TensorBoard", log_dir: str = "outputs/board", **kwargs) -> None:
        """Platforms (reference: utils/io.py:93-151): 'tensorboard' (JSONL
        fallback if the writer is unavailable), 'wandb' (offline mode; a
        missing wandb package is a loud error, NOT a silent fallback), and
        'jsonl' (explicit)."""
        mkdir_if_not_exists(log_dir)
        plat = platform.lower()
        if plat == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._writer = SummaryWriter(log_dir=log_dir)
                return
            except Exception:
                pass
        elif plat == "wandb":
            # reference: utils/io.py:61-91 (WanDBoard). Zero-egress boxes
            # must fail loudly rather than silently drop the curves the
            # user asked for.
            try:
                import wandb  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "platform: wandb requested but the wandb package is not "
                    "installed in this environment. Use platform: "
                    "TensorBoard (or jsonl) instead."
                ) from e
            self._writer = _WandbBoard(log_dir, **kwargs)
            return
        self._writer = _JsonlBoard(log_dir)

    def write(self, data: Dict[str, float], step: Optional[int] = None) -> None:
        if self._writer is None:
            return
        s = int(data.get("step", step if step is not None else 0))
        for k, v in data.items():
            if k == "step":
                continue
            self._writer.add_scalar(k, float(v), s)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
