"""Config system: YAML roots + dotted CLI overrides + timestamped run dirs.

The port's own copy of nfdpm_tpu/utils/config.py: Hydra-style use
(`key.sub=value` overrides, run dir `outputs/${experiment_name}_${now}`) on
plain PyYAML.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional

import yaml


class Config(dict):
    """A dict with attribute access and dotted get/set."""

    def __getattr__(self, k: str) -> Any:
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return Config(node) if isinstance(node, dict) and not isinstance(node, Config) else node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Dict[str, Any] = self
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def to_yaml(self) -> str:
        return yaml.safe_dump(_plain(self), sort_keys=False)


def _plain(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


def _parse_value(s: str) -> Any:
    """YAML-typed scalar parsing: ints, floats, bools, null, lists.
    YAML 1.1 does not treat '1e-3' (no dot) as a float — Hydra does, so we
    post-process scientific-notation strings."""
    try:
        v = yaml.safe_load(s)
    except yaml.YAMLError:
        return s
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return v
    return v


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    """Load a YAML root and apply `key.sub=value` overrides (Hydra CLI
    semantics, e.g. `model.architecture.L=3 data.name=MNIST`)."""
    with open(path) as f:
        cfg = Config(yaml.safe_load(f) or {})
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got: {ov}")
        k, v = ov.split("=", 1)
        cfg.set_dotted(k.lstrip("+"), _parse_value(v))
    return cfg


def make_run_dir(cfg: Config, base: str = "outputs") -> str:
    """Create and return `<base>/${experiment_name}_${now:%Y-%m-%d_%H-%M-%S}`
    with its checkpoints/ and results/ and a copy of the config."""
    ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    name = cfg.get("experiment_name", "exp")
    run_dir = os.path.join(base, f"{name}_{ts}")
    # same-second starts (e.g. fast sweep runs) must not share a dir
    suffix = 2
    while os.path.exists(run_dir):
        run_dir = os.path.join(base, f"{name}_{ts}-{suffix}")
        suffix += 1
    os.makedirs(os.path.join(run_dir, "checkpoints"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "results"), exist_ok=True)
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        f.write(cfg.to_yaml())
    return run_dir


def parse_metric(metric_cfg: Any) -> List[Dict[str, str]]:
    """Zip the per-metric (mode, model_name) lists into config dicts."""
    out = []
    if not metric_cfg:
        return out
    modes = list(metric_cfg.get("mode", []) or [])
    names = list(metric_cfg.get("model_name", []) or [])
    for mode, name in zip(modes, names):
        out.append({"mode": mode, "model_name": name})
    return out
