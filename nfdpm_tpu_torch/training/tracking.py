"""Experiment tracking: scalars, images, parameter histograms.

Counterpart of nfdpm_tpu/training/tracking.py: an append-only JSONL metric
stream (`<run_dir>/metrics.jsonl`) plus PNG image grids under
`<run_dir>/results/`, mirrored to a TensorBoard event stream
(`<run_dir>/tb/`) when tensorboardX is importable (disable with
`NFDPM_NO_TENSORBOARD=1`) and to Aim when `aim` is. The PNG encoder is
written out over zlib, so training needs no imaging library.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, Dict, Optional

import numpy as np

from ..convert import named_leaves
from ..serve import image_grid


class Tracker:
    def __init__(self, run_dir: str, experiment: str = "") -> None:
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._f = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._aim = None
        try:  # optional Aim sink
            import aim

            self._aim = aim.Run(repo=os.path.join(run_dir, "..", "..", "aim"))
            self._aim["experiment"] = experiment
        except Exception:
            self._aim = None
        self._tb = None
        if not os.environ.get("NFDPM_NO_TENSORBOARD"):
            try:  # optional TensorBoard sink; events live under <run_dir>/tb/
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir=os.path.join(run_dir, "tb"))
            except Exception:
                self._tb = None

    @staticmethod
    def _tb_tag(name: str, context: Optional[Dict[str, Any]]) -> str:
        """"bpd" + {"subset": "train"} -> "bpd/train"."""
        subset = (context or {}).get("subset")
        return f"{name}/{subset}" if subset else name

    def track(self, value: Any, name: str, step: Optional[int] = None,
              epoch: Optional[int] = None,
              context: Optional[Dict[str, Any]] = None) -> None:
        if isinstance(value, (int, float, np.floating, np.integer)) or hasattr(value, "item"):
            value = float(value)
        rec = {"t": time.time(), "name": name, "value": value, "step": step,
               "epoch": epoch, "context": context or {}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None and isinstance(value, float):
            try:
                self._tb.add_scalar(self._tb_tag(name, context), value,
                                    global_step=step if step is not None else epoch)
            except Exception:
                pass
        if self._aim is not None:
            try:
                self._aim.track(value=value, name=name, step=step, epoch=epoch,
                                context=context)
            except Exception:
                pass

    def track_param_distributions(self, params, step: Optional[int] = None,
                                  epoch: Optional[int] = None, bins: int = 32) -> None:
        """Per-leaf histograms of the model parameters, as {edges, counts}
        JSONL records (and TensorBoard histograms)."""
        for name, leaf in named_leaves(params):
            arr = leaf.detach().cpu().numpy().ravel()
            if arr.size == 0:
                continue
            counts, edges = np.histogram(arr, bins=bins)
            self.track({"edges": edges.tolist(), "counts": counts.tolist()},
                       name=f"param_dist/{name}", step=step, epoch=epoch)
            if self._tb is not None:
                try:
                    self._tb.add_histogram(f"param_dist/{name}", arr, global_step=step)
                except Exception:
                    pass

    def track_images(self, images: np.ndarray, name: str = "generated",
                     step: Optional[int] = None, epoch: Optional[int] = None,
                     context: Optional[Dict[str, Any]] = None) -> None:
        """Save an 8-wide grid PNG of uint8 [N, H, W, C] images."""
        path = os.path.join(self.run_dir, "results", f"{name}_e{epoch or 0}_s{step or 0}.png")
        grid = save_image_grid(images, path)
        self.track(path, name=f"{name}_path", step=step, epoch=epoch, context=context)
        if self._tb is not None:
            try:
                self._tb.add_image(name, grid, global_step=step, dataformats="HWC")
            except Exception:
                pass

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            try:
                self._tb.close()
            except Exception:
                pass


def png_bytes(grid: np.ndarray) -> bytes:
    """An HWC uint8 image with 1 (grey) or 3 (RGB) channels as a PNG file."""
    h, w, c = grid.shape
    if grid.dtype != np.uint8 or c not in (1, 3):
        raise ValueError(f"png_bytes takes uint8 [H, W, 1 or 3], got {grid.dtype} "
                         f"{grid.shape}")
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), grid.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8,
                    pad: int = 1) -> np.ndarray:
    """images: uint8 [N, H, W, C] (or floats in [-0.5, 0.5]) -> one grid PNG
    on disk; returns the grid array (HWC uint8)."""
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = np.clip((images + 0.5) * 255.0, 0, 255).astype(np.uint8)
    grid = image_grid(images, nrow, pad)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(grid))
    return grid
