"""Part-parallel stage-2 training: each diffusion part on its own ranks.

Counterpart of nfdpm_tpu/parallel/part_parallel.py. A part's group is a
("data", "model") mesh of its own: with the launch's n_model > 1 the part's
UNet is tensor-parallel inside its group (models/unet.shard_unet_) and the
frozen flow is replicated there, as _place_group_state places them in the
JAX package. With a FROZEN flow the per-part diffusion
losses are independent (the joint step only sums them), so the parts train
on disjoint groups of ranks with no communication between the groups:

  * group g holds only part g's UNet, its Adam moments and its EMA shadow;
  * each group runs the frozen flow on its own batches and steps its part
    alone; the gradient all-reduce spans the group's ranks only;
  * batch i goes to group i % P: per epoch every part sees about 1/P of
    the data (scale `epochs` when comparing with joint training).

Groups are disjoint contiguous blocks of the ranks (world // P each, the
remainder idle) or, with fewer ranks than parts, share ranks round-robin:
one process that holds several groups runs them in turn, the
single-device case. A part's step draws what the joint step draws for it
(the dequantization and, before its own, the draws of the parts before it,
dropped), from the same (seed, step) stream, so on the same batches a part
trained alone follows the joint trainer's part bit for bit on one device.

A part's state is a one-part joint state, {"params": {"flow", "diffusion":
{"parts": [unet]}}, "opt_state" over {"diffusion": ...}, "step", "ema"?},
so the joint trainer's loss, optimizer and EMA serve it unchanged.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import apply_matmul_precision, inference, resolve_device
from ..convert import map_tree, named_leaves
from ..models.diffusion_prior import DiffusionPrior
from ..models.nf_backbone import NFBackbone
from ..models.unet import init_unet_
from ..ops import quantize as q
from . import mesh as mesh_m
from . import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class PartGroup:
    """Part g's ranks (global ranks of the launch) and, on a rank among
    them, its mesh over them (None elsewhere)."""
    part: int
    ranks: tuple
    mesh: Optional[mesh_m.Mesh]


def part_group_meshes(n_parts: int, mesh: Optional[mesh_m.Mesh] = None,
                      device=None) -> List[PartGroup]:
    """One group per part over disjoint contiguous rank blocks (equal split;
    remainder ranks idle) or, with fewer ranks than parts, round-robin
    sharing (group g on rank g % world, no model axis). A block's mesh is
    (len / n_model, n_model) with the launch mesh's n_model, which must
    divide it. Every rank calls it (the blocks' process groups are made
    collectively)."""
    world = 1 if mesh is None else mesh.world
    rank = 0 if mesh is None else mesh.rank
    n_model = getattr(mesh, "n_model", 1)
    device = mesh.device if mesh is not None else resolve_device(device)
    per = world // n_parts
    if per >= 1:
        if per % n_model:
            raise ValueError(f"per-group rank count ({per}) not divisible by "
                             f"n_model ({n_model})")
        blocks = [tuple(range(g * per, (g + 1) * per)) for g in range(n_parts)]
    else:
        blocks = [(g % world,) for g in range(n_parts)]
        n_model = 1
    groups = []
    for g, ranks in enumerate(blocks):
        # new_group is collective over the world: every rank makes every block's
        pg = (dist.new_group(list(ranks)) if mesh is not None and mesh.group is not None
              and per >= 1 else None)
        if n_model > 1:
            m = mesh_m.mesh_over(ranks, n_model, device=device, group=pg)
        else:
            m = None
            if rank in ranks:
                m = mesh_m.Mesh(world=len(ranks), rank=ranks.index(rank), group=pg,
                                devices=(device,))
        groups.append(PartGroup(part=g, ranks=ranks, mesh=m))
    return groups


def _unet_placements(group_mesh, unet, prefix: str = "diffusion/parts/0"):
    """The model axis's placements of a group's UNet ({} without one)."""
    from .sharding_rules import unet_model_placements

    return unet_model_placements(unet, 1 if group_mesh is None else group_mesh.n_model, prefix)


def make_part_optimizer(tcfg):
    """Part g's optimizer: the diffusion group of the joint trainer's
    two-group optimizer (the flow never enters it)."""
    from ..training.diffusion_trainer import make_two_group_optimizer

    return make_two_group_optimizer(tcfg, frozen=True)


def init_part_state(seed: int, dp: DiffusionPrior, part_idx: int, flow_params, tx,
                    ema: bool = False, device=None) -> Dict[str, Any]:
    """State for ONE part group: the part's UNet seeded as the joint
    trainer seeds it (seed + part), the frozen flow riding along."""
    device = resolve_device(device)
    unet = dp.place(init_unet_(dp.build_unet(part_idx), seed + part_idx), device,
                    requires_grad=True)
    diffusion = {"parts": [unet]}
    state = {"params": {"flow": flow_params, "diffusion": diffusion},
             "opt_state": tx.init({"diffusion": diffusion}), "step": 0}
    if ema:
        state["ema"] = {"diffusion": {"parts": [copy.deepcopy(unet).requires_grad_(False)]}}
    return state


def make_part_train_step(backbone: NFBackbone, dp: DiffusionPrior, part_idx: int, tcfg, tx,
                         device=None, mesh: Optional[mesh_m.Mesh] = None,
                         inject_noise: bool = False):
    """step(state, batch, seed) -> (state, loss) for ONE part: frozen-flow
    forward, the formater, the part's loss, the part's Adam update (and the
    in-step EMA) over its group's `mesh`. The draws are the joint step's for
    this part (module docstring); `inject_noise=True` takes the joint
    step's injected draws (diffusion_trainer.make_loss_fn) as the third
    argument and uses part `part_idx`'s."""
    from ..training.diffusion_trainer import _STEP, _draw_rows, _draws_on, _ema_lerp_

    if not backbone.frozen:
        raise ValueError("part-parallel training requires a frozen flow: an unfrozen flow "
                         "couples the parts through its gradient, which needs the joint "
                         "train step (diffusion_trainer.make_train_step)")
    device = resolve_device(device)
    apply_matmul_precision()
    generator = torch.Generator(device=device)
    diff = dp.parts[part_idx]
    in_step_ema = tcfg.ema_decay is not None and tcfg.ema_update_every <= 1

    def train_step(state, batch, seed_or_draws):
        params = state["params"]
        unet = params["diffusion"]["parts"][0]
        for p in unet.parameters():
            p.grad = None
        batch = inference._on(device, batch)
        if inject_noise:
            d = seed_or_draws
            if mesh is not None:
                d = _draw_rows(d, mesh_m.data_sharding(mesh, len(d["dequant"])))
            d = _draws_on(device, d)
            g, noise, part = None, d["dequant"], d["parts"][part_idx]
        else:
            g = mesh_m.row_generator(mesh, inference.reseed(
                generator, _STEP, seed_or_draws, state["step"]), batch.shape[0])
            noise, part = None, {}
        x = q.dequantize(g, q.preprocess(batch, tcfg.n_bits), tcfg.n_bits, noise)
        latents, _ = backbone.transform(params["flow"], x)
        z = dp.formater.process_latents(latents)
        if g is not None:
            for j in range(part_idx):
                dp.parts[j].skip_loss_draws(tuple(z[j].shape), g, device)
        loss = diff.loss(unet, z[part_idx], g, t=part.get("t"), noise=part.get("noise"),
                         self_cond=part.get("self_cond"))
        loss.backward()
        loss = loss.detach()
        trained = {"diffusion": params["diffusion"]}
        opt_state = tx.apply(trained, map_tree(trained, lambda p: p.grad), state["opt_state"],
                             mesh, extras=[loss],
                             model_placements=_unet_placements(mesh, unet))
        out = {"params": params, "opt_state": opt_state, "step": state["step"] + 1}
        if "ema" in state:
            if in_step_ema:
                _ema_lerp_(state["ema"], params, True, tcfg.ema_decay, state["step"])
            out["ema"] = state["ema"]
        return out, loss

    return train_step


def make_part_ema_update(tcfg):
    """Per-group periodic EMA update (`ema_update_every` > 1), as the joint
    trainer's make_ema_update: n = step // k."""
    from ..training.diffusion_trainer import _ema_lerp_

    k = max(1, int(tcfg.ema_update_every))

    def apply(state):
        _ema_lerp_(state["ema"], state["params"], True, tcfg.ema_decay, state["step"] // k)
        return state

    return apply


@dataclasses.dataclass
class PartParallelPlan:
    """The groups, this rank's part states and steps (None for a part it
    does not hold), and the merge back to the joint {"flow", "diffusion":
    {"parts": [...]}} tree every consumer reads."""

    backbone: NFBackbone
    flow: Any
    dp: DiffusionPrior
    tcfg: Any
    groups: List[PartGroup]
    states: List[Optional[Dict[str, Any]]]
    steps: List[Any]
    tx: Any
    mesh: Optional[mesh_m.Mesh] = None  # the launch's, every rank on its data axis
    device: Optional[torch.device] = None
    ema_fn: Optional[Any] = None
    n_steps: Optional[List[int]] = None

    @classmethod
    def build(cls, seed: int, backbone: NFBackbone, flow_params, dp: DiffusionPrior, tcfg,
              mesh: Optional[mesh_m.Mesh] = None, device=None) -> "PartParallelPlan":
        device = mesh.device if mesh is not None else resolve_device(device)
        groups = part_group_meshes(dp.num_parts, mesh, device)
        mesh = mesh_m.flat(mesh)
        tx = make_part_optimizer(tcfg)
        ema = tcfg.ema_decay is not None
        states, steps = [], []
        for g, group in enumerate(groups):
            if group.mesh is None:
                states.append(None)
                steps.append(None)
                continue
            state = init_part_state(seed, dp, g, flow_params, tx, ema=ema, device=device)
            mesh_m.replicate(group.mesh, state["params"]["diffusion"])
            state = tp.shard_state(group.mesh.model, state, _unet_placements(
                group.mesh, state["params"]["diffusion"]["parts"][0]))
            states.append(state)
            steps.append(make_part_train_step(backbone, dp, g, tcfg, tx, device, group.mesh))
        ema_fn = (make_part_ema_update(tcfg)
                  if ema and tcfg.ema_update_every > 1 else None)
        return cls(backbone=backbone, flow=flow_params, dp=dp, tcfg=tcfg, groups=groups,
                   states=states, steps=steps, tx=tx, mesh=mesh, device=device,
                   ema_fn=ema_fn, n_steps=[0] * len(groups))

    def holds(self, g: int) -> bool:
        return self.states[g] is not None

    def step_group(self, g: int, batch, seed):
        """Group g's step on (this rank's rows of) the global `batch`."""
        self.states[g], loss = self.steps[g](self.states[g], self.shard_group_batch(g, batch),
                                             seed)
        self.n_steps[g] += 1
        if self.ema_fn is not None and self.n_steps[g] % self.tcfg.ema_update_every == 0:
            self.states[g] = self.ema_fn(self.states[g])
        return loss

    def step_all(self, batches: Sequence[Any], seed) -> List[Optional[torch.Tensor]]:
        """Every held group's step on its batch, in turn; the per-part loss
        scalars (None for a part this rank does not hold)."""
        return [self.step_group(g, b, seed) if self.holds(g) else None
                for g, b in enumerate(batches)]

    def shard_group_batch(self, g: int, batch):
        """This rank's rows of a global batch of group g."""
        return mesh_m.shard_batch(self.groups[g].mesh, batch)

    def _part_from_leader(self, g: int, tree: Optional[Dict[str, torch.Tensor]],
                          like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Group g's tensors (by name) on every rank: broadcast from the
        group's first rank over the launch (nothing to move on one rank)."""
        if self.mesh is None or self.mesh.world == 1:
            return tree
        out = {}
        for name, t in like.items():
            buf = (tree[name].detach().contiguous() if tree is not None
                   else torch.empty(t.shape, dtype=t.dtype, device=self.device))
            dist.broadcast(buf, src=self.groups[g].ranks[0], group=self.mesh.group)
            out[name] = buf
        return out

    def _template(self, g: int) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.dp.build_unet(g).named_parameters()}

    def _whole(self, g: int, tree, prefix: str):
        """Group g's `tree` (rooted at `prefix`) with its model slabs made
        whole (a collective over the group's model group); a module comes
        back as the dict of its parameters."""
        mesh = self.groups[g].mesh
        placements = _unet_placements(mesh, self._held_unet(g), f"{prefix}/parts/0")
        return tp.gather_leaves(mesh.model, tree, placements, prefix)

    def _held_unet(self, g: int):
        return self.states[g]["params"]["diffusion"]["parts"][0]

    def _unet(self, g: int, named: Dict[str, torch.Tensor]):
        unet = self.dp.build_unet(g)
        with torch.no_grad():
            for name, p in unet.named_parameters():
                p.copy_(named[name])
        return self.dp.place(unet, self.device)

    def joint_params(self, prefer_ema: bool = True) -> Dict[str, Any]:
        """Merged {"flow", "diffusion": {"parts": [Unet, ...]}} on every rank
        (a collective when the groups lie on different ranks)."""
        parts = []
        for g in range(len(self.groups)):
            tree = None
            if self.holds(g):
                s = self.states[g]
                src = s["ema"] if (prefer_ema and "ema" in s) else s["params"]
                tree = dict(named_leaves(self._whole(g, src["diffusion"], "diffusion")
                                         ["parts"][0]))
            parts.append(self._unet(g, self._part_from_leader(g, tree, self._template(g))))
        return {"flow": self.flow, "diffusion": {"parts": parts}}

    def group_states_on_all(self) -> List[Dict[str, Any]]:
        """Every group's state (parameters, moments, EMA, step) as a tree of
        tensors, on every rank: what the per-group checkpoint holds."""
        out = []
        for g in range(len(self.groups)):
            s = self.states[g]
            local = None if s is None else dict(named_leaves(
                {"params": {"diffusion": self._whole(g, s["params"]["diffusion"], "diffusion")},
                 "opt_state": {key: {"diffusion": self._whole(
                     g, s["opt_state"][key]["diffusion"], "diffusion")} for key in ("mu", "nu")},
                 **({"ema": {"diffusion": self._whole(g, s["ema"]["diffusion"], "diffusion")}}
                    if "ema" in s else {})}))
            like = self._state_template(g)
            named = self._part_from_leader(g, local, like)
            step = torch.tensor([0 if s is None else s["step"],
                                 0 if s is None else s["opt_state"]["count"]],
                                dtype=torch.int64, device=self.device)
            if self.mesh is not None and self.mesh.world > 1:
                dist.broadcast(step, src=self.groups[g].ranks[0], group=self.mesh.group)
            out.append({"tensors": named, "step": int(step[0]), "count": int(step[1])})
        return out

    def _state_template(self, g: int) -> Dict[str, torch.Tensor]:
        unet = self.dp.build_unet(g)
        named = {n: p.detach() for n, p in unet.named_parameters()}
        out = {}
        keys = ["params/diffusion", "opt_state/mu/diffusion", "opt_state/nu/diffusion"]
        if self.tcfg.ema_decay is not None:
            keys.append("ema/diffusion")
        for key in keys:
            for n, t in named.items():
                out[f"{key}/parts/0/{n}"] = t
        return out

    def restore_group(self, g: int, saved: Dict[str, Any]) -> None:
        """Group g's state from its saved form (group_states_on_all)."""
        if not self.holds(g):
            return
        s = self.states[g]
        tensors = saved["tensors"]
        mesh = self.groups[g].mesh
        placements = _unet_placements(mesh, self._held_unet(g), "")

        def mine(whole, name):  # this rank's model slab of a saved whole leaf
            pl = placements.get(name)
            return whole if pl is None else pl.slab(whole, mesh.model_rank)

        with torch.no_grad():
            for prefix, tree in (("params/diffusion", s["params"]["diffusion"]),
                                 ("ema/diffusion", s.get("ema", {}).get("diffusion"))):
                if tree is None:
                    continue
                for n, p in tree["parts"][0].named_parameters():
                    p.copy_(mine(tensors[f"{prefix}/parts/0/{n}"], n))
            for key in ("mu", "nu"):
                for path, t in named_leaves(s["opt_state"][key], f"opt_state/{key}"):
                    t.copy_(mine(tensors[path], path.rsplit("/parts/0/", 1)[-1]))
        s["step"] = int(saved["step"])
        s["opt_state"]["count"] = int(saved["count"])
        self.n_steps[g] = s["step"]


def train_part_parallel(*, backbone: NFBackbone, flow_params, dp: DiffusionPrior, tcfg,
                        loaders, run_dir: str, logger, seed: int = 42,
                        resume_dir: Optional[str] = None, resume_epoch: Optional[int] = None,
                        evaluate_fn=None, mesh: Optional[mesh_m.Mesh] = None,
                        device=None) -> Dict[str, Any]:
    """Part-parallel counterpart of diffusion_trainer.train (same run-dir
    artifacts). Batch i goes to group i % P; the ranks of group g keep only
    its batches and their rows of them.

    Every save writes TWO checkpoints: `model_diffusion_parts_*`, the exact
    per-group states (parameters, Adam moments, EMA, step), the resume
    source of this trainer; and `model_diffusion_*`, the merged joint view
    {"params": {"flow", "diffusion"}, "ema"?, "step"} that phase=eval,
    runload, `serve --run-dir` and the sample commands read unchanged."""
    from ..training.checkpoint import save_state
    from ..training.diffusion_trainer import make_sample_fn
    from ..training.tracking import tracker_for
    from ..utils.profiling import StepTimer

    if not backbone.frozen:
        raise ValueError("part-parallel training requires a frozen flow")
    device = mesh.device if mesh is not None else resolve_device(device)
    plan = PartParallelPlan.build(seed, backbone, flow_params, dp, tcfg, mesh, device)
    mesh = plan.mesh  # the launch, every rank on the data axis
    n_parts = dp.num_parts
    logger.info(f"Part-parallel: {n_parts} groups over ranks "
                f"{[list(g.ranks) for g in plan.groups]}")
    tracker = tracker_for(run_dir, mesh)
    loss_name = dp.parts[0].cfg.loss_type

    start_epoch, current_iter = 0, 0
    if resume_dir is not None and resume_epoch is not None:
        saved = _load_groups(resume_dir, resume_epoch, device)
        for g, group_state in enumerate(saved["groups"]):
            plan.restore_group(g, group_state)
        start_epoch = resume_epoch
        current_iter = int(saved["step"])
        logger.info(f"Resumed part states from {resume_dir} @ {resume_epoch}")

    def joint_view():
        view = {"params": plan.joint_params(prefer_ema=False), "step": current_iter}
        if tcfg.ema_decay is not None:
            view["ema"] = {"diffusion": plan.joint_params(prefer_ema=True)["diffusion"]}
        return view

    def save(epoch: int) -> None:
        groups = plan.group_states_on_all()
        save_state(run_dir, "diffusion_parts", epoch,
                   {"groups": groups, "step": current_iter}, mesh)
        save_state(run_dir, "diffusion", epoch, joint_view(), mesh)

    def merged():
        return plan.joint_params(prefer_ema=tcfg.ema_decay is not None)

    sample_fn = make_sample_fn(backbone, dp, tcfg, seed, device, mesh)
    log_count = 0
    epoch = start_epoch
    try:
        for epoch in range(start_epoch + 1, start_epoch + tcfg.epochs + 1):
            t0 = time.time()
            timer = StepTimer()
            pending = [[] for _ in range(n_parts)]
            for i, (batch, _labels) in enumerate(loaders.train.iter_epoch(epoch - 1)):
                g = i % n_parts
                if plan.holds(g):
                    with timer.step():
                        loss = plan.step_group(g, batch, seed)
                    pending[g].append(loss)
                current_iter += 1
                if current_iter % tcfg.print_freq == 0:
                    per_part = _per_part_means(plan, pending)
                    pending = [[] for _ in range(n_parts)]
                    avg = float(np.nanmean(per_part))
                    tracker.track(avg, loss_name, step=current_iter, epoch=epoch,
                                  context={"subset": "train"})
                    logger.info(f"epoch {epoch} iter {current_iter}: {loss_name} {avg:.4f} "
                                f"(per-part {['%.4f' % x for x in per_part]})")
                    log_count += 1
                    if log_count % tcfg.log_gen_images_per_iter == 0:
                        samples = sample_fn(merged(), tcfg.n_samples_log, tcfg.temperature,
                                            2 * current_iter + 1)
                        tracker.track_images(samples.cpu().numpy(), "generated",
                                             step=current_iter, epoch=epoch)
            ts = timer.summary()
            logger.info(f"epoch {epoch} done in {time.time() - t0:.1f}s "
                        f"(group-step p50 {ts.get('p50_ms', 0):.1f}ms "
                        f"p95 {ts.get('p95_ms', 0):.1f}ms)")
            if epoch % tcfg.save_checkpoint_freq == 0:
                params = merged()
                if evaluate_fn is not None:
                    evaluate_fn(sample_fn, params, epoch)
                save(epoch)
                samples = sample_fn(params, 64, tcfg.temperature, 2 * epoch)
                tracker.track_images(samples.cpu().numpy(), "checkpoint_samples",
                                     step=current_iter, epoch=epoch)
    except KeyboardInterrupt:
        save(epoch)
        logger.warning(f"Interrupted — emergency checkpoint at epoch {epoch}")
        raise

    final_epoch = start_epoch + tcfg.epochs
    save(final_epoch)
    results = {}
    if evaluate_fn is not None:
        results["metrics"] = evaluate_fn(sample_fn, merged(), final_epoch, full=True)
    tracker.close()
    return {"state": joint_view(), "results": results, "sample_fn": sample_fn, "plan": plan}


def _load_groups(run_dir: str, epoch: int, device) -> Dict[str, Any]:
    from ..training.checkpoint import _load, _place

    tree = _load(run_dir, "diffusion_parts", epoch)
    for g in tree["groups"]:
        g["tensors"] = _place(g["tensors"], device)
    return tree


def _per_part_means(plan: PartParallelPlan, pending) -> List[float]:
    """Each part's mean loss since the last log, on every rank: its group's
    first rank contributes its (group-averaged) losses, one all-reduce."""
    n = len(pending)
    vec = torch.zeros(2 * n, dtype=torch.float64, device=plan.device)
    for g, losses in enumerate(pending):
        group = plan.groups[g]
        if losses and group.mesh is not None and group.mesh.rank == 0:
            vec[g] = torch.stack(losses).double().sum()
            vec[n + g] = len(losses)
    if plan.mesh is not None:
        mesh_m.all_reduce_sum_(plan.mesh, vec)
    sums, counts = vec[:n].cpu().numpy(), vec[n:].cpu().numpy()
    return [float(s / c) if c else math.nan for s, c in zip(sums, counts)]
