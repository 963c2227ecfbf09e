"""The frozen reference against the port at a tiny size, so that the
reference is itself checked: Glow L2/K2 width 16 forward and inverse, a
UNet of dim 8, a DDIM-5 chain, a train step with Adam (CPU, fp32; the
reference in fp64)."""

import numpy as np
import pytest
import torch

from perfbench.bench import inputs
from perfbench.entries.glow_sample import glow_config
from perfbench.entries.glow_train import _tree
from perfbench.reference import diffusion as ref_diffusion
from perfbench.reference import glow as ref_glow
from perfbench.reference import train as ref_train
from perfbench.reference import unet as ref_unet
from perfbench.tests.tinycells import SEED, tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def flow_spec():
    return tiny("glow-cifar10.sample")


def test_glow_forward_matches_the_port(flow_spec):
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.models import prior as prior_m

    p = inputs.glow_params(flow_spec.config, SEED, CPU)
    x = torch.rand(3, 8, 8, 3, generator=torch.Generator().manual_seed(1)) - 0.5
    latents, ldj, logp = glow_m.forward(p["flow"], glow_config(flow_spec.config), x)
    port = ldj + logp + prior_m.gaussian_prior_logp(p["prior"], latents[-1])
    ref = ref_glow.forward({**ref_glow.cast(p["flow"], torch.float64),
                            "prior": ref_glow.cast(p["prior"], torch.float64)}, x.double())
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=1e-5, atol=1e-3)


def test_glow_inverse_matches_the_port(flow_spec):
    from nfdpm_tpu_torch.models import glow as glow_m

    p = inputs.glow_params(flow_spec.config, SEED, CPU)
    shapes = [(3, *s) for s in ref_glow.latent_shapes(2, 8, 3)]
    z = inputs.normal_parts(shapes, SEED, 0, CPU)
    port = glow_m.inverse(p["flow"], glow_config(flow_spec.config), z)
    ref = ref_glow.inverse(ref_glow.cast(p["flow"], torch.float64), [t.double() for t in z])
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_unet_and_ddim_match_the_port():
    from nfdpm_tpu_torch.models.diffusion import DiffusionConfig, GaussianDiffusion
    from nfdpm_tpu_torch.models.unet import Unet, to_device

    spec = tiny("nfdp-cifar10.sample")
    u, d = spec.config["unet"], spec.config["diffusion"]
    gelu = spec.config["time_mlp_gelu"]
    shapes = ref_unet.param_shapes(u["dim"], u["dim_mults"], 6)
    P = inputs.unet_params(shapes, spec.config, SEED, 0, CPU)
    net = to_device(Unet(dim=u["dim"], dim_mults=tuple(u["dim_mults"]), channels=6,
                         resnet_block_groups=u["resnet_block_groups"]), CPU)
    assert dict((k, tuple(v.shape)) for k, v in net.named_parameters()) == shapes
    with torch.no_grad():
        for k, v in net.named_parameters():
            v.copy_(P[k])
    x = torch.randn(2, 4, 4, 6, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([7])
    P64 = {k: v.double() for k, v in P.items()}
    with torch.no_grad():
        port = net(x, t)
        ref = ref_unet.unet(P64, x.double(), t, u["dim"], u["dim_mults"],
                            u["resnet_block_groups"], gelu)
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)

    cfg = DiffusionConfig(image_size=4, channels=6, timesteps=d["timesteps"],
                          sampling_timesteps=d["sampling_timesteps"], beta_schedule="cosine",
                          ddim_sampling_eta=1.0, auto_normalize=False)
    diff = GaussianDiffusion(lambda m, xx, tt, sc: m(xx, tt), cfg)
    noise = list(torch.randn(d["sampling_timesteps"] + 1, 2, 4, 4, 6,
                             generator=torch.Generator().manual_seed(3)).unbind(0))
    with torch.no_grad():
        port = diff.ddim_sample(net, (2, 4, 4, 6), noise=noise)
        ref = ref_diffusion.ddim_chain(
            lambda xx, tt: ref_unet.unet(P64, xx, tt, u["dim"], u["dim_mults"],
                                         u["resnet_block_groups"], gelu),
            [n.double() for n in noise], d["timesteps"], d["sampling_timesteps"], 1.0)
    np.testing.assert_allclose(port.numpy(), ref.numpy(), atol=5e-3)


def test_train_step_matches_the_port():
    from nfdpm_tpu_torch.convert import trainable
    from nfdpm_tpu_torch.training import nf_trainer

    spec = tiny("glow-cifar10.train")
    t = spec.config["training"]
    p = inputs.glow_params(spec.config, SEED, CPU)
    start = {k: v.clone() for k, v in ref_train.leaves(p)}
    tcfg = nf_trainer.NFTrainConfig(lr=t["lr"], n_bits=5, lr_warmup_steps=0)
    tx = nf_trainer.optimizer_of(tcfg)
    params = trainable(p)
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    step = nf_trainer.make_train_step(glow_config(spec.config), tcfg, tx, inject_noise=True,
                                      device=CPU)
    g = torch.Generator().manual_seed(4)
    batch = torch.randint(0, 256, (4, 8, 8, 3), generator=g).float() / 255.0
    noise = torch.rand(4, 8, 8, 3, generator=g)
    state, metrics = step(state, batch, noise)
    out = ref_train.train_steps(_tree(start, CPU), [batch], [noise], 5, t["lr"], 0,
                                torch.float64)
    assert abs(float(metrics["bpd"]) - out["bpd"][0]) < 1e-5
    after = dict(ref_train.leaves(state["params"]))
    moved = {k: after[k].detach() - start[k] for k in out["params"]}
    moved_ref = {k: out["params"][k] - start[k].double() for k in out["params"]}
    assert ref_train.norm_gap(moved, moved_ref)["value"] < 1e-3
    mu = dict(ref_train.leaves(state["opt_state"]["mu"]))
    grad = {k: mu[k] / (1 - tx.b1) for k in out["grad1"]}
    assert ref_train.norm_gap(grad, out["grad1"])["value"] < 1e-4
