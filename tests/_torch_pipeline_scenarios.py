"""Rank scenarios of the pipeline over K (parallel/pipeline.py), run by
tests/_torch_parallel_worker.py in tests/test_torch_pipeline.py's launch of
four gloo ranks. Each records what the test compares with the JAX package
and with one process; a stage's parameters are gathered whole first."""

import os

import numpy as np
import torch

from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.parallel import mesh as mesh_m
from nfdpm_tpu_torch.parallel import sharding_rules as rules

from _torch_tp_scenarios import flat, glow_config

# (n_model, microbatches) of the forward: the stages of a (1, 4) and a
# (2, 2) mesh, one microbatch on each, one stage on a (4, 1) mesh
FORWARD_MESHES = ((4, 4), (4, 1), (2, 4), (2, 1), (1, 2))


def _stage_state(mesh, tree_path):
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    tcfg = tnft.NFTrainConfig(lr=1e-3)
    tx = tnft.optimizer_of(tcfg)
    params = convert.trainable(convert.from_jax_params(convert.load_npz(tree_path), "cpu"))
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    return tcfg, tx, tnft.shard_nf_state(mesh, tx, state, pipeline=True)


def pp_forward(job, mesh, d):
    """pp_forward of this rank's rows (its data index's) on each mesh of
    FORWARD_MESHES: latents, logdet and the split priors' log-density."""
    from nfdpm_tpu_torch.parallel import pipeline as pl

    cfg = glow_config(job, **job["pp_glow"])
    x = np.load(os.path.join(d, "pp_x.npz"))["x"]
    out = {}
    for n_model, microbatches in FORWARD_MESHES:
        m = mesh_m.make_mesh(n_model=n_model, device="cpu")
        _, _, state = _stage_state(m, os.path.join(d, "pp_tree.npz"))
        rows = torch.from_numpy(x[mesh_m.data_sharding(m, len(x))])
        with torch.no_grad():
            latents, ldj, logp = pl.pp_forward(state["params"]["flow"], cfg, rows, m,
                                               microbatches)
        tag = f"m{n_model}_mb{microbatches}"
        out[f"{tag}/rows"] = np.asarray([m.data_rank, len(rows)])
        for i, z in enumerate(latents):
            out[f"{tag}/z{i}"] = z.numpy()
        out[f"{tag}/ldj"], out[f"{tag}/logp"] = ldj.numpy(), logp.numpy()
    return out


def pp_steps(job, mesh, d):
    """Two pipelined Adam steps with the JAX package's injected noise on the
    (2, 2) and (1, 4) meshes, M = 4: bits/dim, the whole parameters after
    each; a stage's flow parameter and moment bytes beside the whole
    flow's and the placements' prediction."""
    from nfdpm_tpu_torch.training import nf_trainer as tnft

    cfg = glow_config(job, **job["pp_glow"])
    inputs = np.load(os.path.join(d, "pp_steps.npz"))
    whole = convert.from_jax_params(convert.load_npz(os.path.join(d, "pp_tree.npz")), "cpu")
    out = {}
    for n_model in (2, 4):
        m = mesh_m.make_mesh(n_model=n_model, device="cpu")
        tcfg, tx, state = _stage_state(m, os.path.join(d, "pp_tree.npz"))
        placements = state["layout"].placements
        flow_moments = {k: state["opt_state"][k]["flow"] for k in ("mu", "nu")}
        out[f"m{n_model}/bytes"] = np.asarray([
            rules.param_bytes({"flow": state["params"]["flow"]})
            + rules.moment_bytes(flow_moments),
            3 * rules.param_bytes({"flow": whole["flow"]}),
            rules.param_bytes(state["params"]),
            rules.predicted_param_bytes(whole, placements, m.model_rank),
            rules.moment_bytes(state["opt_state"]),
            rules.predicted_moment_bytes(whole, placements, m.model_rank)])
        step = tnft.make_train_step(cfg, tcfg, tx, inject_noise=True, device="cpu",
                                    pp=(m, 4))
        bpds = []
        for i in range(len(inputs["imgs"])):
            state, metrics = step(state, mesh_m.shard_batch(m, inputs["imgs"][i]),
                                  inputs["noise"][i])
            bpds.append(float(metrics["bpd"]))
            out.update(flat(convert.to_jax_params(tnft.whole_nf_state(m, state)["params"]),
                            f"m{n_model}/step{i + 1}"))
        out[f"m{n_model}/bpd"] = np.asarray(bpds)
    return out


SCENARIOS = {"pp_forward": pp_forward, "pp_steps": pp_steps}
