"""Latent formaters: between the flow's L latent parts and the diffusion
prior's input tensors.

Counterpart of nfdpm_tpu/models/formaters.py:

  * IdentityFormater: the L parts pass through, one diffusion model each.
  * CatFormater: every part is squeezed or unsqueezed (the flow's squeeze,
    channel order (c, h2, w2)) to the middle part's resolution and the parts
    are concatenated along channels into one tensor; `postprocess` is the
    exact inverse.
  * standardize hooks: the identity without `stats`; with per-processed-part
    channelwise (mean, std) they apply z' = (z - mean) / std, and
    `stats_log_sigma_total` is the constant sum(log std) over all dims that
    turns an NLL of z' back into one of z.

Stateless: every shape follows from (L, in_channels, size). NHWC.
`fit_formater_stats` fits the stats from batches of flow latents.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.bijectors import squeeze_forward, squeeze_inverse
from .glow import GlowConfig, latent_shapes_nhwc

# per-processed-part ((mean_c, ...), (std_c, ...)), plain floats
StatsT = Tuple[Tuple[Tuple[float, ...], Tuple[float, ...]], ...]


@dataclasses.dataclass(frozen=True)
class BaseFormater:
    L: int
    in_channels: int
    size: int
    stats: Optional[StatsT] = None  # None: identity hooks

    @property
    def latent_shapes(self) -> List[Tuple[int, int, int]]:
        return latent_shapes_nhwc(GlowConfig(in_channels=self.in_channels, levels=self.L),
                                  self.size)

    def _map_stats(self, latents: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
        if self.stats is None:
            return list(latents)
        if len(latents) != len(self.stats):
            raise ValueError(f"{len(latents)} parts for {len(self.stats)} stats")
        out = []
        for z, (mean, std) in zip(latents, self.stats):
            out.append(fn(z, torch.tensor(mean, dtype=z.dtype, device=z.device),
                          torch.tensor(std, dtype=z.dtype, device=z.device)))
        return out

    def standardize_latents(self, latents: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._map_stats(latents, lambda z, m, s: (z - m) / s)

    def inv_standardize_latents(self, latents: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._map_stats(latents, lambda z, m, s: z * s + m)

    def stats_log_sigma_total(self) -> float:
        """sum(log std) over every standardized dim; 0.0 without stats."""
        if self.stats is None:
            return 0.0
        total = 0.0
        for (h, w, c), (_mean, std) in zip(self.input_shapes, self.stats):
            if len(std) != c:
                raise ValueError(f"{len(std)} stds for {c} channels")
            total += float(h) * float(w) * float(np.sum(np.log(np.asarray(std, np.float64))))
        return total

    def with_stats(self, stats: StatsT) -> "BaseFormater":
        return dataclasses.replace(self, stats=stats)


@dataclasses.dataclass(frozen=True)
class IdentityFormater(BaseFormater):
    """L parts straight through, L diffusion models."""

    def process_latents(self, latents: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self.standardize_latents(latents)

    def postprocess(self, latents: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self.inv_standardize_latents(latents)

    @property
    def num_parts(self) -> int:
        return self.L

    @property
    def input_shapes(self) -> List[Tuple[int, int, int]]:
        return self.latent_shapes


@dataclasses.dataclass(frozen=True)
class CatFormater(BaseFormater):
    """All parts at the middle part's resolution, concatenated along
    channels into one tensor; `postprocess` splits them back."""

    @property
    def target_idx(self) -> int:
        return (self.L - 1) // 2

    def _degrees(self) -> List[int]:
        """+d: squeeze d times (finer parts); -d: unsqueeze (coarser)."""
        return [self.target_idx - i for i in range(self.L)]

    @property
    def _cat_channels(self) -> List[int]:
        return [c * (4 ** d) if d >= 0 else c // (4 ** (-d))
                for (_h, _w, c), d in zip(self.latent_shapes, self._degrees())]

    def process_latents(self, latents: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        parts = []
        for z, d in zip(latents, self._degrees()):
            for _ in range(d):
                z = squeeze_forward(z)
            for _ in range(-d):
                z = squeeze_inverse(z)
            parts.append(z)
        return self.standardize_latents([torch.cat(parts, dim=-1)])

    def postprocess(self, latents: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(latents) != 1:
            raise ValueError("CatFormater expects a single latent tensor")
        cat = self.inv_standardize_latents(latents)[0]
        out = []
        for z, d in zip(torch.split(cat, self._cat_channels, dim=-1), self._degrees()):
            for _ in range(d):
                z = squeeze_inverse(z)
            for _ in range(-d):
                z = squeeze_forward(z)
            out.append(z)
        return out

    @property
    def num_parts(self) -> int:
        return 1

    @property
    def input_shapes(self) -> List[Tuple[int, int, int]]:
        h, w, _ = self.latent_shapes[self.target_idx]
        return [(h, w, sum(self._cat_channels))]


def get_formater(name: str):
    if name == "IdentityFormater":
        return IdentityFormater
    if name == "CatFormater":
        return CatFormater
    raise ValueError("Invalid formater name")


def stats_from_json(obj) -> Optional[StatsT]:
    """Stats as stored in a diffusion architecture JSON (lists); None or
    empty -> None."""
    if not obj:
        return None
    return tuple((tuple(float(x) for x in mean), tuple(float(x) for x in std))
                 for mean, std in obj)


def fit_formater_stats(formater: BaseFormater, latent_batches, eps: float = 1e-6) -> StatsT:
    """Channelwise mean and std of the formater's PROCESSED parts.

    `latent_batches` iterates over lists of raw flow-latent parts (one list
    per batch, NHWC tensors or arrays). The geometry (squeeze, concatenate)
    is applied without any existing standardization, then the first and
    second moments accumulate per channel in float64 on the host; the std
    is floored at `eps`. Returns the plain-float stats for
    `formater.with_stats(...)`."""
    base = dataclasses.replace(formater, stats=None)
    sums = sumsqs = counts = None
    for latents in latent_batches:
        parts = base.process_latents([torch.as_tensor(np.asarray(z, np.float32))
                                      if not isinstance(z, torch.Tensor) else z.detach()
                                      for z in latents])
        parts = [z.cpu().numpy().astype(np.float64) for z in parts]
        if sums is None:
            sums = [np.zeros(z.shape[-1]) for z in parts]
            sumsqs = [np.zeros(z.shape[-1]) for z in parts]
            counts = [0.0] * len(parts)
        for i, z in enumerate(parts):
            sums[i] += z.sum(axis=(0, 1, 2))
            sumsqs[i] += (z * z).sum(axis=(0, 1, 2))
            counts[i] += float(np.prod(z.shape[:-1]))
    if sums is None:
        raise ValueError("fit_formater_stats: empty latent_batches")
    stats = []
    for s, ss, c in zip(sums, sumsqs, counts):
        mean = s / c
        std = np.maximum(np.sqrt(np.maximum(ss / c - mean * mean, 0.0)), eps)
        stats.append((tuple(float(v) for v in mean), tuple(float(v) for v in std)))
    return tuple(stats)
