"""The whole-Glow-step megakernel of nfdpm_tpu_torch held against nfdpm_tpu on the CPU.

nfdpm_tpu's step_megakernel_forward runs in interpret mode, as its own test
(tests/test_pallas_kernels.py, TestStepMegakernel) runs it; the port's
wrapper takes its plain version on CPU tensors. Weights come from the JAX
package's init with every leaf but p_mat and sign moved by seeded noise (the
actnorms and the zeroconv start at zero, which would make the coupling the
identity), converted through _torch_port.port_tree. Tolerances: y 1e-5,
the logdet rtol 1e-5 and atol 1e-3 (the JAX test's bounds: a sum over every
pixel and channel of the step); a chained Glow's latents 1e-5 and bits/dim
1e-4, as tests/test_torch_glow.py holds the port's other routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, one_torch_thread, port_tree, randomize, t, to_numpy_tree
from nfdpm_tpu.models import glow as jglow
from nfdpm_tpu.models import prior as jprior
from nfdpm_tpu.ops import bijectors as jbj
from nfdpm_tpu.ops.pallas import step_megakernel as jsm
from nfdpm_tpu.training import nf_trainer as nft
from nfdpm_tpu_torch import convert
from nfdpm_tpu_torch.models import glow as tglow
from nfdpm_tpu_torch.models import prior as tprior
from nfdpm_tpu_torch.ops import bijectors as tbj
from nfdpm_tpu_torch.ops import quantize as tq
from nfdpm_tpu_torch.ops.kernels import step_megakernel as tsm


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


LDJ_TOL = dict(rtol=1e-5, atol=1e-3)


def test_taps_matches_jax():
    w = np.random.default_rng(0).standard_normal((3, 3, 5, 7)).astype(np.float32)  # HWIO
    want = np.asarray(jsm._taps(jnp.asarray(w)))
    got = tsm.taps(t(w.transpose(3, 2, 0, 1)))
    assert got.shape == (9, 5, 7) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


# the JAX package's own case (odd batch: its tile of 4 pads it), and one
# like the served Glow's second level at a narrow width (C 24, 8x8)
@pytest.mark.parametrize("b,h,w,c,width", [(5, 16, 16, 12, 64), (3, 8, 8, 24, 32)],
                         ids=["jax-case", "level2-like"])
def test_step_megakernel_matches_jax(b, h, w, c, width):
    tree = randomize(to_numpy_tree(jbj.init_step(3, c, width=width)), seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    x = np.random.default_rng(2).standard_normal((b, h, w, c)).astype(np.float32)

    wf, bf, ld = jbj.fold_actnorm_invconv(jparams["actnorm"], jparams["invconv"])
    y_j, tail_j = jsm.step_megakernel_forward(jnp.asarray(x), wf, bf,
                                              jparams["coupling"]["net"], tile_b=4,
                                              interpret=True)
    tparams = port_tree(tree)
    twf, tbf, tld = tbj.fold_actnorm_invconv(tparams["actnorm"], tparams["invconv"])
    y_t, tail_t = tsm.step_megakernel_forward(t(x), twf, tbf, tparams["coupling"]["net"])
    close(y_t, y_j)
    close(tail_t, tail_j, **LDJ_TOL)

    # the whole step, the mix's logdet added, as TestStepMegakernel composes it
    y_s, ldj_s = tbj.step_forward_megakernel(tparams, t(x), torch.zeros(b))
    close(y_s, y_j)
    close(ldj_s, np.asarray((h * w) * ld + tail_j), **LDJ_TOL)
    # and against the JAX model's own step (XLA route)
    y_ref, ldj_ref = jbj.step_forward(jparams, jnp.asarray(x), jnp.zeros((b,)))
    close(y_s, y_ref)
    close(ldj_s, ldj_ref, **LDJ_TOL)


def _chained_forward(flow, x):
    """glow.forward's level walk with every step through the megakernel."""
    ldj = torch.zeros(x.shape[0])
    logp = torch.zeros(x.shape[0])
    latents, y = [], x
    for block in flow["blocks"]:
        y = tbj.squeeze_forward(y)
        for sp in block["steps"]:
            y, ldj = tbj.step_forward_megakernel(sp, y, ldj)
        y, ldj, z, logp = tbj.split_forward(block["split"], y, ldj, logp)
        latents.append(z)
    y = tbj.squeeze_forward(y)
    for sp in flow["final_steps"]:
        y, ldj = tbj.step_forward_megakernel(sp, y, ldj)
    latents.append(y)
    return latents, ldj, logp


def test_glow_chained_through_megakernel_matches_jax():
    """A small Glow (L2/K2, width 24, 8x8x3, batch 3), each step through
    step_forward_megakernel, against the JAX flow's forward and bits/dim on
    the same dequantization draw."""
    kw = dict(in_channels=3, levels=2, steps=2, coupling_width=24)
    jcfg = jglow.GlowConfig(**kw)
    tree = randomize(to_numpy_tree({
        "flow": jglow.init_glow(0, jcfg),
        "prior": jprior.init_gaussian_prior(tglow.final_channels(tglow.GlowConfig(**kw)),
                                            True)}), seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree, "cpu")
    imgs = np.random.default_rng(3).integers(0, 256, (3, 8, 8, 3)).astype(np.float32) / 255.0

    x = np.asarray(imgs) - 0.5
    lat_j, ldj_j, logp_j = jglow.forward(jparams["flow"], jcfg, jnp.asarray(x))
    lat_t, ldj_t, logp_t = _chained_forward(tparams["flow"], t(x))
    assert len(lat_t) == len(lat_j)
    for a, b in zip(lat_t, lat_j):
        close(a, b)
    close(ldj_t, ldj_j, **LDJ_TOL)
    close(logp_t, logp_j, **LDJ_TOL)

    key, salt = jax.random.PRNGKey(4), np.int32(2)
    bpd_j = nft.make_eval_step(jcfg, nft.NFTrainConfig(n_bits=5))(
        jparams, jnp.asarray(imgs), key, salt)
    noise = jax.random.uniform(jax.random.fold_in(key, salt), imgs.shape, jnp.float32)
    xq = tq.dequantize(None, tq.preprocess(t(imgs), 5), 5, t(noise))
    lat, ldj, logp = _chained_forward(tparams["flow"], xq)
    ll = ldj + logp + tprior.gaussian_prior_logp(tparams["prior"], lat[-1])
    n_pixel = tprior.n_pixels(8, 3)
    bpd_t = (np.log(2.0 ** 5) * n_pixel - ll) * (np.log2(np.e) / n_pixel)
    close(bpd_t, bpd_j, atol=1e-4)


def test_wrapper_refuses_a_gradient_and_bad_inputs():
    tparams = port_tree(randomize(to_numpy_tree(jbj.init_step(3, 8, width=16)), seed=1))
    net = tparams["coupling"]["net"]
    wf, bf, _ = tbj.fold_actnorm_invconv(tparams["actnorm"], tparams["invconv"])
    x = torch.randn(2, 4, 4, 8)
    with pytest.raises(RuntimeError, match="no gradient"):
        tsm.step_megakernel_forward(x.clone().requires_grad_(True), wf, bf, net)
    with pytest.raises(RuntimeError, match="no gradient"):
        tbj.step_forward_megakernel({**tparams, "actnorm": {
            k: v.clone().requires_grad_(True) for k, v in tparams["actnorm"].items()}},
            x, torch.zeros(2))
    with torch.no_grad():  # the same call where no gradient is wanted
        assert tsm.step_megakernel_forward(x.requires_grad_(True), wf, bf, net)[0].shape \
            == x.shape
    with pytest.raises(ValueError, match="odd"):
        tsm.step_megakernel_forward(torch.randn(2, 4, 4, 7), wf, bf, net)
    with pytest.raises(ValueError, match="conv2.w"):
        tsm.step_megakernel_forward(x.detach(), wf, bf,
                                    dict(net, conv2={"w": torch.randn(24, 24, 1, 1)}))
    with pytest.raises(ValueError, match="w_fold"):
        tsm.step_megakernel_forward(x.detach(), wf[:4], bf, net)


def test_halo_waste_counts_the_clipped_border():
    """The scatter zeroconv needs no border, so there is none to clip: the
    kernel runs its products on blocks x 16 mt pixels, the last block's
    rows past the end included (tests/test_torch_kernels_plan.py counts
    them pixel by pixel)."""
    plan = tsm.Plan(mt=4, stages=4, blocks=256, smem=0)
    assert tsm.halo_waste(plan, 64, 16, 16) == 1.0
    assert tsm.halo_waste(plan._replace(mt=1, blocks=20), 7, 5, 9) == 320 / 315
    assert tsm.halo_waste(plan._replace(mt=2, blocks=3), 1, 9, 9) == 96 / 81
