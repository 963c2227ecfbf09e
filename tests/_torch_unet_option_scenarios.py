"""The UNet options' scenario for tests/_torch_parallel_worker.py: stage-2
steps with `remat` on the UNets, on two gloo ranks on the CPU.

`remat_unet` runs the job's stage-2 steps twice on the same two ranks:
at the job's (data 1, model 2) mesh, whose UNets have one GroupNorm group
split over both ranks, and as a data axis of two with fsdp (each UNet block
gathering its slabs on use). Each time with remat off and on: the losses,
the whole parameters after the steps, and each rank's collectives of the
first step (the model group's all-reduces and all-gathers, fsdp's gathers
and reduce-scatters), those a ResnetBlock unit runs in the forward (its
gather on use and its forward) apart.
Imports the port only (no JAX).
"""

import os

import numpy as np
import torch.distributed as dist

from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import unet as unet_m
from nfdpm_tpu_torch.parallel import mesh as mesh_m
from nfdpm_tpu_torch.parallel import tensor_parallel as tp
from nfdpm_tpu_torch.parallel import zero

from _torch_spatial_scenarios import _diffusion_prior, _whole_diffusion_params, flat

KINDS = ("all_reduce", "all_gather", "fsdp_gather", "fsdp_reduce_scatter")


class CollectiveCount:
    """Counts the collectives each kind of call makes, and those made while
    the UNet runs a ResnetBlock unit (Unet._unit: the block's gather on use
    and its forward; not the recompute, which autograd runs), by wrapping
    the module functions the port calls them through."""

    def __init__(self):
        self.total = dict.fromkeys(KINDS, 0)
        self.in_block = dict.fromkeys(KINDS, 0)
        self.depth = 0
        wraps = [(tp, "_all_reduce", "all_reduce"), (tp, "all_gather_dim", "all_gather"),
                 (zero, "_gather", "fsdp_gather"),
                 (zero, "_reduce_scatter_mean", "fsdp_reduce_scatter")]
        self.saved = [(m, name, getattr(m, name)) for m, name, _ in wraps]
        for module, name, kind in wraps:
            setattr(module, name, self._counted(kind, getattr(module, name)))
        unit = unet_m.Unet._unit

        def counted_unit(unet, name, module, *args):
            block = isinstance(module, unet_m.ResnetBlock)
            self.depth += block
            try:
                return unit(unet, name, module, *args)
            finally:
                self.depth -= block

        self.saved.append((unet_m.Unet, "_unit", unit))
        unet_m.Unet._unit = counted_unit

    def _counted(self, kind, fn):
        def wrapper(*args, **kwargs):
            self.total[kind] += 1
            if self.depth:
                self.in_block[kind] += 1
            return fn(*args, **kwargs)
        return wrapper

    def restore(self):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def _steps(job, mesh, d, remat: bool, fsdp: bool):
    """The job's stage-2 configuration's steps on `mesh` with the JAX
    package's draws injected, the UNets with `remat`: the losses, the whole
    parameters after, and the first step's collectives."""
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone
    from nfdpm_tpu_torch.training import diffusion_trainer as tdt
    from _torch_spatial_scenarios import glow_config

    conf = job["stage2"][0]
    inputs = np.load(os.path.join(d, f"stage2_{conf['name']}.npz"))
    tree = convert.load_npz(os.path.join(d, f"stage2_{conf['name']}_tree.npz"))
    dp = _diffusion_prior(dict(job, unet=dict(job["unet"], remat=remat)), conf["formater"])
    tcfg = tdt.DiffusionTrainConfig(**conf["tcfg"])
    tx = tdt.make_two_group_optimizer(tcfg, conf["frozen"])
    bb = NFBackbone(glow_config(job, **job["glow2"]), job["img2"], frozen=conf["frozen"])
    params = convert.diffusion_from_jax_params(tree, dp, "cpu", requires_grad=True)
    params.pop("prior")
    state = tdt.shard_diffusion_state(mesh, tx, {"params": params,
                                                 "opt_state": tx.init(params), "step": 0}, fsdp)
    step = tdt.make_train_step(bb, dp, tcfg, tx, inject_noise=True, device="cpu", mesh=mesh)
    tag = f"{'fsdp' if fsdp else 'model2'}_remat{int(remat)}"
    out, losses = {}, []
    for i in range(len(inputs["imgs"])):
        draws = {"dequant": inputs[f"dequant_{i}"],
                 "parts": [{"t": inputs[f"t_{i}_{j}"], "noise": inputs[f"noise_{i}_{j}"],
                            "self_cond": bool(inputs[f"coin_{i}_{j}"])}
                           for j in range(dp.num_parts)]}
        count = CollectiveCount() if i == 0 else None
        try:
            state, m = step(state, mesh_m.shard_batch(mesh, inputs["imgs"][i]), draws)
        finally:
            if count is not None:
                count.restore()
        if count is not None:
            out[f"{tag}/collectives"] = np.asarray([count.total[k] for k in KINDS])
            out[f"{tag}/collectives_in_block"] = np.asarray([count.in_block[k] for k in KINDS])
        losses.append(float(m["loss"]))
    out[f"{tag}/loss"] = np.asarray(losses)
    out.update(flat(_whole_diffusion_params(mesh, state, dp), f"{tag}/params"))
    return out


def remat_unet(job, mesh, d):
    """The steps at the job's (data 1, model 2) mesh, then on a data axis of
    the same two ranks with fsdp, each with remat off and on."""
    data = mesh_m.mesh_over([0, 1], n_model=1, device="cpu", group=dist.new_group([0, 1]))
    out = {}
    for m, fsdp in ((mesh, False), (data, True)):
        for remat in (False, True):
            out.update(_steps(job, m, d, remat, fsdp))
    return out


SCENARIOS = {"remat_unet": remat_unet}
