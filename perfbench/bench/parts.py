"""The seconds of the parts of a cell's set-up, which the result line's
`about` gives beside setup_s, so that a set-up that swings shows where."""

from __future__ import annotations

import contextlib
import time

import torch


class Parts(dict):
    """{part: seconds}; `timed(part)` adds a block's seconds, the device's
    work synchronized at its end."""

    def __init__(self, device):
        super().__init__()
        self.device = device

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.time()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self[name] = self.get(name, 0.0) + time.time() - t0
