"""Random draws that a data-parallel rank makes for the whole global batch.

Every draw of the port's training, scoring and sampling paths goes through
`rand`, `randn` or `randint` here with the generator it was given. A plain
torch.Generator draws as torch.rand / randn / randint do. A `RowGenerator`
wraps the generator of a data-parallel step: it draws the GLOBAL batch's
numbers (the batch axis of the asked shape widened to `total` rows) from
the wrapped generator, on its device, and keeps this rank's rows
[start, stop). Every rank steps the same generator through the same
sequence of global draws, so rank r's rows are bit for bit the rows a
single device draws for the whole batch: the numbers do not change with
the world size (parallel/mesh.py).

`batch_dim=None` marks a draw shared by the whole batch (the
self-conditioning coin), which every rank takes whole.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass
class RowGenerator:
    """`generator`'s draws for a batch of `total` rows, of which this rank
    keeps [start, stop), delivered on `device` (default: the generator's)."""

    generator: torch.Generator
    start: int
    stop: int
    total: int
    to_device: Optional[torch.device] = None

    @property
    def device(self) -> torch.device:
        return self.to_device if self.to_device is not None else self.generator.device


def _draw(fn, shape: Sequence[int], generator, batch_dim: Optional[int], device, **kw):
    if not isinstance(generator, RowGenerator):
        return fn(tuple(shape), generator=generator, device=device, **kw)
    shape = list(shape)
    g = generator
    if batch_dim is not None:
        if shape[batch_dim] != g.stop - g.start:
            raise ValueError(f"a draw of {shape[batch_dim]} rows on axis {batch_dim} from a "
                             f"generator of rows [{g.start}, {g.stop})")
        shape[batch_dim] = g.total
    out = fn(tuple(shape), generator=g.generator, device=g.generator.device, **kw)
    if batch_dim is not None:
        out = out.narrow(batch_dim, g.start, g.stop - g.start)
    return out if device is None else out.to(device)


def rand(shape, generator, device=None, dtype=torch.float32, batch_dim: Optional[int] = 0):
    """U(0, 1) of `shape`, as torch.rand."""
    return _draw(torch.rand, shape, generator, batch_dim, device, dtype=dtype)


def randn(shape, generator, device=None, dtype=torch.float32, batch_dim: Optional[int] = 0):
    """N(0, 1) of `shape`, as torch.randn."""
    return _draw(torch.randn, shape, generator, batch_dim, device, dtype=dtype)


def randint(high: int, shape, generator, device=None, batch_dim: Optional[int] = 0):
    """Integers in [0, high) of `shape`, as torch.randint(0, high, ...)."""
    return _draw(lambda s, **kw: torch.randint(0, high, s, **kw), shape, generator,
                 batch_dim, device)
