"""Environment, seeding and logging utilities.

Counterpart of nfdpm_tpu/utils/env.py. Randomness on the device flows
through explicit `torch.Generator`s that the trainer seeds itself, so
`set_seeds` only has the host's generators to seed.
"""

from __future__ import annotations

import logging
import platform
import sys

import numpy as np
import torch


def setup_logger(name: str = "base", log_file: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s", "%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def log_environment(logger: logging.Logger, device: torch.device) -> None:
    logger.info(f"Python version: {sys.version}")
    logger.info(f"Platform: {platform.platform()}")
    logger.info(f"torch version: {torch.__version__} (CUDA {torch.version.cuda}), "
                f"numpy version: {np.__version__}")
    if device.type == "cuda":
        logger.info(f"Device: {device} = {torch.cuda.get_device_name(device)}, "
                    f"{torch.cuda.device_count()} visible")
    else:
        logger.info(f"Device: {device}")
    from .. import matmul_precision

    logger.info(f"matmul_precision: {matmul_precision() or 'unset'}; "
                f"TF32: cudnn {torch.backends.cudnn.allow_tf32}, "
                f"matmul {torch.backends.cuda.matmul.allow_tf32}")


def set_seeds(seed: int = 42) -> None:
    """Seed the host's generators (numpy's and torch's global ones)."""
    np.random.seed(seed)
    torch.manual_seed(seed)


def parse_train_eval_mode(phase: str) -> bool:
    if phase not in ("train", "eval"):
        raise ValueError(f"phase must be 'train' or 'eval', got {phase}")
    return phase == "train"
