"""Stage-1 training, the Glow user's epoch: nf_trainer.make_train_step's
`train_step` (5-bit bits/dim, backward, value and norm clips, Adam) at the
traffic's batch, fed from the seeded CIFAR-shaped set through
data/pipeline.Loader (shuffled epochs) and prefetch_to_device's producer
thread. Each step's U(0, 1) dequantization draw is made on the device from
(seed, step) and handed over (`inject_noise`).

Set-up builds the one train state and drives it through the first
CHECKED_STEPS steps by the window's own call and feed; the window goes on
from there. Check, against the reference (perfbench/reference/train.py)
following those steps from the same weights, batches and draws:
  bpd_gap: the widest gap of the steps' bits/dim;
  grad_gap: step 1's gradient as Adam took it (its first moment over
      1 - b1), by the worst leaf's gap of norms;
  update_gap: the parameters' change over the steps, likewise.
A leaf whose reference gradient at step 1 is under a thousandth of the
median leaf's is left out of both leaf comparisons (its updates are
Adam's answer to round-off).
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from perfbench.bench import inputs
from perfbench.bench.parts import Parts
from perfbench.cost import glow as glow_cost
from perfbench.entries.glow_sample import glow_config
from perfbench.reference import DTYPE
from perfbench.reference import train as ref_train

TRAFFIC = ("batch", "dataset_images")  # the traffic keys this entry reads
LIBRARIES = ("flow_kernels",)  # the program's kernel libraries it runs
NATIVE = True  # and the native batch assembly (the loader's)
CHECKED_STEPS = 3
SKIP_BELOW = 1e-3  # of the median leaf's step-1 gradient norm


def _host(tree, trained_only: bool = True) -> Dict[str, torch.Tensor]:
    """{"flow/...": a host copy} of the tree's leaves (the trained ones)."""
    return {path: t.detach().to("cpu", copy=True) for path, t in ref_train.leaves(tree)
            if ref_train.trained(path) or not trained_only}


class Cell:
    def __init__(self, spec, seed: int, device):
        from nfdpm_tpu_torch.convert import trainable
        from nfdpm_tpu_torch.data.datasets import ArrayDataset
        from nfdpm_tpu_torch.data.pipeline import Loader, prefetch_to_device
        from nfdpm_tpu_torch.training import nf_trainer

        self.spec, self.seed, self.device = spec, seed, device
        cfg, tr = spec.config, spec.traffic
        img, t = cfg["image"], cfg["training"]
        self.batch = tr["batch"]
        self.images_per_call = self.batch
        self.n_bits, self.lr, self.warmup = img["n_bits"], t["lr"], t["lr_warmup_steps"]
        tcfg = nf_trainer.NFTrainConfig(lr=t["lr"], optimizer=t["optimizer"],
                                        n_bits=img["n_bits"],
                                        lr_warmup_steps=t["lr_warmup_steps"])
        tx = nf_trainer.optimizer_of(tcfg)
        self.b1 = tx.b1
        self.setup_parts = Parts(device)
        with self.setup_parts.timed("weights"):
            weights = inputs.glow_params(cfg, seed, device)
        self.initial = _host(weights, trained_only=False)
        params = trainable(weights)
        self.state = {"params": params, "opt_state": tx.init(params), "step": 0}
        self.train_step = nf_trainer.make_train_step(glow_config(cfg), tcfg, tx,
                                                     inject_noise=True, device=device)
        with self.setup_parts.timed("data"):
            data = inputs.images(tr["dataset_images"], img["size"], img["channels"], seed,
                                 device)
        loader = Loader(ArrayDataset(data, np.zeros(len(data), np.int64)), self.batch,
                        shuffle=True, drop_last=True, seed=int(seed) % (1 << 63))

        def epochs():
            e = 0
            while True:
                yield from loader.iter_epoch(e)
                e += 1

        self.feed = prefetch_to_device(epochs(), device)
        self.waits = []
        self.done = 0
        self.batches, self.bpd = [], []
        for _ in range(CHECKED_STEPS):
            with self.setup_parts.timed(f"step_{self.done + 1}"):
                self.call(self.done)
            self.batches.append(self.last_batch.cpu())
            self.bpd.append(float(self.metrics["bpd"]))
            if self.done == 1:
                mu = self.state["opt_state"]["mu"]
                self.grad1 = {k: v / (1.0 - self.b1) for k, v in _host(mu).items()}
        self.after = _host(self.state["params"])
        self.waits.clear()

    def call(self, i: int) -> None:
        t0 = time.perf_counter()
        self.last_batch = next(self.feed)[0]
        self.waits.append(time.perf_counter() - t0)
        self.done += 1
        noise = inputs.step_noise(self.last_batch.shape, self.seed, self.done, self.device)
        self.state, self.metrics = self.train_step(self.state, self.last_batch, noise)

    def close(self) -> None:
        self.feed.close()
        self.feed = self.state = self.train_step = self.metrics = self.last_batch = None

    def work(self) -> Dict:
        cfg = self.spec.config
        return {"flops": 3 * self.batch * glow_cost.flow_flops_per_image(cfg, splits=True),
                "flow": glow_cost.mix_tail_work(cfg, self.batch, ("forward", "backward")),
                "steps": 1, "loader_waits": list(self.waits),
                "about": {"last_bpd": float(self.metrics["bpd"]), "steps_done": self.done}}

    def check(self) -> Dict[str, float]:
        dev = self.device
        params = _tree(self.initial, dev)
        noises = [inputs.step_noise(b.shape, self.seed, s + 1, dev)
                  for s, b in enumerate(self.batches)]
        out = ref_train.train_steps(params, [b.to(dev) for b in self.batches], noises,
                                    self.n_bits, self.lr, self.warmup, DTYPE)
        g_ref = {k: v.cpu() for k, v in out["grad1"].items()}
        norms = sorted(float(torch.linalg.vector_norm(v.double())) for v in g_ref.values())
        floor = SKIP_BELOW * norms[len(norms) // 2]
        skip = [k for k, v in g_ref.items() if float(torch.linalg.vector_norm(v.double())) < floor]
        init = {k: v for k, v in self.initial.items() if ref_train.trained(k)}
        moved = {k: self.after[k].double() - init[k].double() for k in init}
        moved_ref = {k: out["params"][k].cpu().double() - init[k].double() for k in init}
        grad = ref_train.norm_gap(self.grad1, g_ref, skip)
        update = ref_train.norm_gap(moved, moved_ref, skip)
        self.skipped, self.worst = skip, {"grad": grad["leaf"], "update": update["leaf"]}
        return {"bpd_gap": max(abs(a - b) if math.isfinite(a - b) else math.inf
                               for a, b in zip(self.bpd, out["bpd"])),
                "grad_gap": grad["value"], "update_gap": update["value"]}


def _tree(flat: Dict[str, torch.Tensor], device) -> Dict:
    """The tree of {path: leaf}, on `device`."""
    root: Dict = {}
    for path, t in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.to(device)
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}
