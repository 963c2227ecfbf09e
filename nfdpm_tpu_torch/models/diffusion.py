"""Gaussian diffusion (DDPM): schedules, samplers and the full-T VLB.

Counterpart of the sampling and scoring half of nfdpm_tpu/models/diffusion.py:
the beta schedules and `make_schedule` (fp64 numpy, stored as fp32), the KL
and discretized-likelihood helpers, and from `GaussianDiffusion` the q
process, the objective conversions, learned variances, the ancestral, DDIM
and DPM-Solver++(2M) chains, `sample_given_start`, `interpolate`, the
variational bound, and the training loss (`p_losses`, `loss`: the three
objectives, l1 and l2, p2 weights, self-conditioning, and the hybrid loss of
learned variances).

The JAX package runs each chain as one `lax.scan`; here a chain is a Python
loop over the same time grid. Inside a chain t is the same for the whole
batch, so it is passed as a Python int: the schedule constants become
Python scalars taken from the fp32 tables (no gather on the device), and
the model gets a length-1 time vector that broadcasts over the batch, as in
the JAX package. The VLB passes per-sample time tensors, as JAX does.

Random draws. JAX derives every draw from a key; here each chain takes a
`torch.Generator` or injected `noise`, a sequence whose first entry is x_T
and whose entry 1 + j is the N(0, 1) draw of the j-th step of the chain (the
JAX package draws fold_in(k_loop, t) for the ancestral chain and
fold_in(k_loop, j) for DDIM). A step that adds no noise (ancestral t = 0,
DDIM with sigma = 0) draws nothing from the generator. The VLB takes
`noise[t]` per timestep t, JAX's fold_in(key, t). `sample_given_start`
takes noise[0] for the q draw to T-1 and noise[1 + j] for step j;
`interpolate` noise[0] and noise[1] for the two q draws and noise[2 + j]
for step j. The training loss takes its timesteps `t`, its N(0, 1) `noise`
and the self-conditioning coin `self_cond` (JAX's bernoulli(k_scdrop)), or
draws them from the generator in that order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

Time = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# Beta schedules, fp64 numpy
# ---------------------------------------------------------------------------

def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    betas = np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64)
    return np.clip(betas, 0.0, 0.999)  # beta = 1 at T <= 20 would make ᾱ = 0


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    ac = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(timesteps: int, start: float = -3, end: float = 3,
                          tau: float = 1) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    sigmoid = lambda v: 1 / (1 + np.exp(-v))
    v_start, v_end = sigmoid(start / tau), sigmoid(end / tau)
    ac = (-sigmoid((t * (end - start) + start) / tau) + v_end) / (v_end - v_start)
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


_SCHEDULES = {"linear": linear_beta_schedule, "cosine": cosine_beta_schedule,
              "sigmoid": sigmoid_beta_schedule}


class Schedule(NamedTuple):
    """ᾱ-derived constants, fp32 numpy."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    p2_loss_weight: np.ndarray
    log_betas: np.ndarray
    # improved-DDPM's lower endpoint of the learned log-variance, with the
    # t = 1 posterior variance standing in at t = 0 (where it is exactly 0)
    posterior_log_variance_ipd: np.ndarray


def make_schedule(beta_schedule: str, timesteps: int, p2_gamma: float = 0.0,
                  p2_k: float = 1.0) -> Schedule:
    betas = _SCHEDULES[beta_schedule](timesteps)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    f32 = lambda a: np.asarray(a, np.float32)
    return Schedule(
        betas=f32(betas),
        alphas_cumprod=f32(ac),
        alphas_cumprod_prev=f32(ac_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - ac)),
        log_one_minus_alphas_cumprod=f32(np.log(1 - ac)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1 / ac)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1 / ac - 1)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(np.log(np.maximum(post_var, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1 - ac)),
        posterior_mean_coef2=f32((1 - ac_prev) * np.sqrt(alphas) / (1 - ac)),
        p2_loss_weight=f32((p2_k + ac / (1 - ac)) ** -p2_gamma),
        log_betas=f32(np.log(betas)),
        posterior_log_variance_ipd=f32(
            np.log(np.append(post_var[1] if len(post_var) > 1 else betas[0],
                             post_var[1:]))),
    )


# ---------------------------------------------------------------------------
# KL and discretized likelihood; scalars or tensors
# ---------------------------------------------------------------------------

def _exp(v):
    return torch.exp(v) if isinstance(v, torch.Tensor) else math.exp(v)


def normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + _exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * _exp(-logvar2))


def gaussian_log_likelihood(x, means, log_scales, bin_eps: float = 1e-1):
    """Discretized Gaussian log-likelihood (±bin_eps bins) through the tanh
    approximation of the normal CDF."""

    def approx_cdf(v):
        return 0.5 * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (v + 0.044715 * v ** 3)))

    centered = x - means
    inv_stdv = _exp(-log_scales)
    cdf_delta = approx_cdf(inv_stdv * (centered + bin_eps)) - approx_cdf(
        inv_stdv * (centered - bin_eps))
    return torch.log(torch.clamp(cdf_delta, min=1e-12))


def _mean_flat(t: torch.Tensor) -> torch.Tensor:
    return torch.mean(t.reshape(t.shape[0], -1), dim=1)


# ---------------------------------------------------------------------------
# GaussianDiffusion
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """The JAX package's DiffusionConfig, field for field, so that a run's
    diffusion_kwargs pass through. `loss_type`, the p2 weights and
    `vlb_loss_weight` only matter to training; `scan_unroll` has no
    counterpart in a Python loop."""

    image_size: int
    channels: int = 3
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None
    loss_type: str = "l1"
    objective: str = "pred_noise"   # 'pred_noise' | 'pred_x0' | 'pred_v'
    beta_schedule: str = "sigmoid"  # 'linear' | 'cosine' | 'sigmoid'
    p2_loss_weight_gamma: float = 0.0
    p2_loss_weight_k: float = 1.0
    ddim_sampling_eta: float = 0.0
    auto_normalize: bool = True
    self_condition: bool = False
    learned_variance: bool = False
    vlb_loss_weight: float = 1.0
    vlb_clip_denoised: bool = True
    vlb_decoder: str = "discretized"  # 'discretized' | 'density'
    sampling_method: str = "auto"     # 'auto' | 'ancestral' | 'ddim' | 'dpm++'
    vlb_time_chunk: int = 1
    scan_unroll: int = 1


def _ddim_times(num_timesteps: int, sampling_timesteps: int) -> list:
    """[T-1, ..., -1]: the strided grid of the DDIM and DPM++ chains."""
    times = np.linspace(-1, num_timesteps - 1, sampling_timesteps + 1)
    return list(reversed(times.astype(int).tolist()))


class GaussianDiffusion:
    """The diffusion process around `model_apply(params, x, t, self_cond)`;
    `t` reaches the model as a [B] or length-1 int64 tensor."""

    def __init__(self, model_apply: Callable, cfg: DiffusionConfig):
        self.model_apply = model_apply
        self.cfg = cfg
        self.sched = make_schedule(cfg.beta_schedule, cfg.timesteps,
                                   cfg.p2_loss_weight_gamma, cfg.p2_loss_weight_k)
        self.num_timesteps = cfg.timesteps
        self.sampling_timesteps = cfg.sampling_timesteps or cfg.timesteps
        if self.sampling_timesteps > cfg.timesteps:
            raise ValueError(f"sampling_timesteps {self.sampling_timesteps} > "
                             f"timesteps {cfg.timesteps}")
        self.is_ddim_sampling = self.sampling_timesteps < cfg.timesteps
        self._tables: Dict[tuple, torch.Tensor] = {}

    # -- schedule lookup ---------------------------------------------------
    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._tables:
            a = (1.0 - self.sched.alphas_cumprod if name == "one_minus_alphas_cumprod"
                 else getattr(self.sched, name))
            self._tables[key] = torch.from_numpy(np.asarray(a, np.float32)).to(device)
        return self._tables[key]

    def _extract(self, name: str, t: Time, ndim: int):
        """Schedule constant `name` at t: a Python float for an int t, else
        a [len(t), 1, ...] tensor that broadcasts against an ndim tensor."""
        if isinstance(t, int):
            if name == "one_minus_alphas_cumprod":
                return float(np.float32(1.0) - self.sched.alphas_cumprod[t])
            return float(getattr(self.sched, name)[t])
        return self._table(name, t.device)[t].reshape(t.shape[0], *((1,) * (ndim - 1)))

    def _model(self, params, x, t: Time, x_self_cond):
        if isinstance(t, int):
            t = torch.full((1,), t, dtype=torch.int64, device=x.device)
        return self.model_apply(params, x, t, x_self_cond)

    # -- normalization -----------------------------------------------------
    def normalize(self, x):
        return x * 2.0 - 1.0 if self.cfg.auto_normalize else x

    def unnormalize(self, x):
        return (x + 1.0) * 0.5 if self.cfg.auto_normalize else x

    # -- q process -----------------------------------------------------------
    def q_sample(self, x_start, t: Time, noise):
        return (self._extract("sqrt_alphas_cumprod", t, x_start.dim()) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t, x_start.dim()) * noise)

    def q_mean_variance(self, x_start, t: Time):
        n = x_start.dim()
        mean = self._extract("sqrt_alphas_cumprod", t, n) * x_start
        var = self._extract("one_minus_alphas_cumprod", t, n)
        logvar = self._extract("log_one_minus_alphas_cumprod", t, n)
        return mean, var, logvar

    def q_posterior(self, x_start, x_t, t: Time):
        n = x_t.dim()
        mean = (self._extract("posterior_mean_coef1", t, n) * x_start
                + self._extract("posterior_mean_coef2", t, n) * x_t)
        var = self._extract("posterior_variance", t, n)
        logvar = self._extract("posterior_log_variance_clipped", t, n)
        return mean, var, logvar

    # -- objective conversions ---------------------------------------------
    def predict_start_from_noise(self, x_t, t: Time, noise):
        n = x_t.dim()
        return (self._extract("sqrt_recip_alphas_cumprod", t, n) * x_t
                - self._extract("sqrt_recipm1_alphas_cumprod", t, n) * noise)

    def predict_noise_from_start(self, x_t, t: Time, x0):
        n = x_t.dim()
        return ((self._extract("sqrt_recip_alphas_cumprod", t, n) * x_t - x0)
                / self._extract("sqrt_recipm1_alphas_cumprod", t, n))

    def predict_v(self, x_start, t: Time, noise):
        n = x_start.dim()
        return (self._extract("sqrt_alphas_cumprod", t, n) * noise
                - self._extract("sqrt_one_minus_alphas_cumprod", t, n) * x_start)

    def predict_start_from_v(self, x_t, t: Time, v):
        n = x_t.dim()
        return (self._extract("sqrt_alphas_cumprod", t, n) * x_t
                - self._extract("sqrt_one_minus_alphas_cumprod", t, n) * v)

    def _split_model_out(self, out):
        """(prediction, raw variance interpolant) with learned variances,
        split along channels; (out, None) otherwise."""
        if not self.cfg.learned_variance:
            return out, None
        return out.chunk(2, dim=-1)

    def _learned_logvar(self, var_raw, t: Time, ndim: int):
        """f = (v + 1) / 2; logvar = f log(beta_t) + (1 - f) log(beta-tilde_t)."""
        frac = (var_raw + 1.0) * 0.5
        min_log = self._extract("posterior_log_variance_ipd", t, ndim)
        max_log = self._extract("log_betas", t, ndim)
        return frac * max_log + (1.0 - frac) * min_log

    def model_predictions(self, params, x, t: Time, x_self_cond=None,
                          clip_x_start: bool = False, model_out=None,
                          return_var: bool = False):
        out = self._model(params, x, t, x_self_cond) if model_out is None else model_out
        out, var_raw = self._split_model_out(out)
        clip = (lambda v: torch.clamp(v, -1.0, 1.0)) if clip_x_start else (lambda v: v)
        if self.cfg.objective == "pred_noise":
            pred_noise = out
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
        elif self.cfg.objective == "pred_x0":
            x_start = clip(out)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        elif self.cfg.objective == "pred_v":
            x_start = clip(self.predict_start_from_v(x, t, out))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:
            raise ValueError(self.cfg.objective)
        if return_var:
            return pred_noise, x_start, var_raw
        return pred_noise, x_start

    def p_mean_variance(self, params, x, t: Time, x_self_cond=None,
                        clip_denoised: bool = True, model_out=None):
        _, x_start, var_raw = self.model_predictions(
            params, x, t, x_self_cond, model_out=model_out, return_var=True)
        if clip_denoised:
            x_start = torch.clamp(x_start, -1.0, 1.0)
        mean, var, logvar = self.q_posterior(x_start, x, t)
        if self.cfg.learned_variance:
            logvar = self._learned_logvar(var_raw, t, x.dim())
            var = torch.exp(logvar)
        return mean, var, logvar, x_start

    # -- sampler chains ------------------------------------------------------
    @staticmethod
    def _start(shape, generator, noise):
        if noise is not None:
            return noise[0]
        if generator is None:
            raise ValueError("a sampler needs a generator or injected noise")
        return torch.randn(shape, generator=generator, device=generator.device)

    @staticmethod
    def _step_noise(shape, generator, noise, j: int, device, first: int = 1):
        if noise is not None:
            return noise[first + j]
        return torch.randn(shape, generator=generator, device=device)

    def _ancestral(self, params, img, t_start: int, generator, noise, first: int = 1):
        """Ancestral steps t = t_start .. 0 from img; step j draws
        noise[first + j]; no noise at t = 0."""
        shape = tuple(img.shape)
        x_sc = torch.zeros_like(img)
        for j, t in enumerate(range(t_start, -1, -1)):
            sc = x_sc if self.cfg.self_condition else None
            mean, _, logvar, x_sc = self.p_mean_variance(params, img, t, sc,
                                                         clip_denoised=True)
            if t > 0:
                eps = self._step_noise(shape, generator, noise, j, img.device, first)
                img = mean + _exp(0.5 * logvar) * eps
            else:
                img = mean
        return img

    def p_sample_loop(self, params, shape, generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None):
        """The T-step ancestral chain, t = T-1 .. 0; no noise at t = 0."""
        img = self._start(shape, generator, noise)
        return self.unnormalize(self._ancestral(params, img, self.num_timesteps - 1,
                                                generator, noise))

    def sample_given_start(self, params, x_start, generator: Optional[torch.Generator] = None,
                           noise: Optional[Sequence[torch.Tensor]] = None):
        """Noise x_start to t = T-1 with q_sample, then the full ancestral
        chain back."""
        shape = tuple(x_start.shape)
        t_last = self.num_timesteps - 1
        img = self.q_sample(x_start, t_last, self._start(shape, generator, noise))
        return self.unnormalize(self._ancestral(params, img, t_last, generator, noise))

    def interpolate(self, params, x1, x2, t: Optional[int] = None, lam: float = 0.5,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None):
        """Noise x1 and x2 to t (default T-1), mix them (1 - lam, lam), and
        denoise from t-1 to 0, as the JAX package does (it starts the chain
        one step below t and does not unnormalize)."""
        t = self.num_timesteps - 1 if t is None else int(t)
        shape = tuple(x1.shape)
        draw = (lambda i: noise[i]) if noise is not None else (
            lambda i: torch.randn(shape, generator=generator, device=x1.device))
        xt1 = self.q_sample(x1, t, draw(0))
        xt2 = self.q_sample(x2, t, draw(1))
        img = (1 - lam) * xt1 + lam * xt2
        return self._ancestral(params, img, t - 1, generator, noise, first=2)

    def ddim_sample(self, params, shape, generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None):
        """DDIM over linspace(-1, T-1, S+1) reversed; step j pairs (t, t_next),
        the last one (0, -1) with alpha_next = 1. The step's scalars are fp32,
        computed on the host."""
        eta = np.float32(self.cfg.ddim_sampling_eta)
        times = _ddim_times(self.num_timesteps, self.sampling_timesteps)
        ac = self.sched.alphas_cumprod
        img = self._start(shape, generator, noise)
        x_sc = torch.zeros_like(img)
        zero = np.float32(0.0)
        for j, (t, t_next) in enumerate(zip(times[:-1], times[1:])):
            sc = x_sc if self.cfg.self_condition else None
            pred_noise, x_sc = self.model_predictions(params, img, t, sc, clip_x_start=True)
            alpha = ac[t]
            alpha_next = np.float32(1.0) if t_next < 0 else ac[t_next]
            sigma = eta * np.sqrt(np.maximum(
                (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha), zero))
            c = np.sqrt(np.maximum(1 - alpha_next - sigma ** 2, zero))
            img = x_sc * float(np.sqrt(alpha_next)) + float(c) * pred_noise
            if sigma > 0:
                img = img + float(sigma) * self._step_noise(shape, generator, noise, j,
                                                            img.device)
        return self.unnormalize(img)

    def dpmpp_sample(self, params, shape, generator: Optional[torch.Generator] = None,
                     noise: Optional[Sequence[torch.Tensor]] = None):
        """DPM-Solver++(2M) on the DDIM grid. With lambda_t = log(alpha_t /
        sigma_t) and h_i = lambda_{t_i} - lambda_{t_{i-1}}, the step's
        extrapolation coefficient is c_i = h_{i-1} / (2 h_i) (0 at the first
        and terminal steps, which are DDIM(eta = 0) steps), computed on the
        host in fp64 and applied in fp32:
            D = (1 + c) x0 - c x0_prev
            x = sqrt(ac_next) D + sqrt(1 - ac_next) (x - sqrt(ac) D) / sqrt(1 - ac)
        Only x_T is drawn."""
        times = _ddim_times(self.num_timesteps, self.sampling_timesteps)
        ac = self.sched.alphas_cumprod
        ac64 = np.asarray(ac, np.float64)

        def lam(t: int) -> float:
            return math.inf if t < 0 else 0.5 * (math.log(ac64[t]) - math.log1p(-ac64[t]))

        hs = [lam(t_next) - lam(t) for t, t_next in zip(times[:-1], times[1:])]
        cs = [0.0] + [0.0 if math.isinf(h) else h_prev / (2.0 * h)
                      for h_prev, h in zip(hs[:-1], hs[1:])]
        one = np.float32(1.0)
        img = self._start(shape, generator, noise)
        x0_prev = torch.zeros_like(img)
        for t, t_next, c in zip(times[:-1], times[1:], np.asarray(cs, np.float32)):
            sc = x0_prev if self.cfg.self_condition else None
            _, x0 = self.model_predictions(params, img, t, sc, clip_x_start=True)
            x0_d = float(one + c) * x0 - float(c) * x0_prev
            ac_t = ac[t]
            ac_next = one if t_next < 0 else ac[t_next]
            eps_d = (img - float(np.sqrt(ac_t)) * x0_d) * float(one / np.sqrt(one - ac_t))
            img = float(np.sqrt(ac_next)) * x0_d + float(np.sqrt(one - ac_next)) * eps_d
            x0_prev = x0
        return self.unnormalize(img)

    def sample(self, params, batch_size: int = 16,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None):
        """`sampling_method` dispatch; 'auto' is DDIM iff sampling_timesteps
        < timesteps."""
        shape = (batch_size, self.cfg.image_size, self.cfg.image_size, self.cfg.channels)
        method = self.cfg.sampling_method
        if method == "auto":
            method = "ddim" if self.is_ddim_sampling else "ancestral"
        chains = {"dpm++": self.dpmpp_sample, "ddim": self.ddim_sample,
                  "ancestral": self.p_sample_loop}
        if method not in chains:
            raise ValueError(f"unknown sampling_method: {method!r}")
        return chains[method](params, shape, generator, noise)

    # -- training loss ---------------------------------------------------------
    def p_losses(self, params, x_start, t: torch.Tensor, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 self_cond: Optional[bool] = None) -> torch.Tensor:
        """Scalar loss at the per-sample timesteps t [B]. With
        self-conditioning, the coin `self_cond` (drawn if None, p = 1/2)
        decides whether the model first predicts x0 from x_t, without a
        gradient, as its own conditioning input. With learned variances the
        VLB term trains only the variance half (the prediction detached),
        weighted vlb_loss_weight * T / 1000."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device)
        x = self.q_sample(x_start, t, noise)

        x_self_cond = None
        if self.cfg.self_condition:
            if self_cond is None:
                self_cond = bool(torch.rand((), generator=generator,
                                            device=generator.device) < 0.5)
            if self_cond:
                with torch.no_grad():  # the JAX package's stop_gradient
                    _, x_self_cond = self.model_predictions(params, x, t)
            else:
                x_self_cond = torch.zeros_like(x)

        out_full = self._model(params, x, t, x_self_cond)
        out, var_raw = self._split_model_out(out_full)
        if self.cfg.objective == "pred_noise":
            target = noise
        elif self.cfg.objective == "pred_x0":
            target = x_start
        elif self.cfg.objective == "pred_v":
            target = self.predict_v(x_start, t, noise)
        else:
            raise ValueError(self.cfg.objective)
        if self.cfg.loss_type == "l1":
            loss = torch.abs(out - target)
        elif self.cfg.loss_type == "l2":
            loss = (out - target) ** 2
        else:
            raise ValueError(self.cfg.loss_type)
        loss = torch.mean(_mean_flat(loss) * self._extract("p2_loss_weight", t, 1))

        if self.cfg.learned_variance:
            frozen = torch.cat([out.detach(), var_raw], dim=-1)
            vb = self._vb_terms_bpd(params, x_start, x, t, x_self_cond, clip_denoised=False,
                                    model_out=frozen)
            loss = loss + (self.cfg.vlb_loss_weight * (self.num_timesteps / 1000.0)
                           * torch.mean(vb))
        return loss

    def loss(self, params, img, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             self_cond: Optional[bool] = None) -> torch.Tensor:
        """t ~ U{0, ..., T-1} per sample (or given), normalize, p_losses."""
        if t is None:
            t = torch.randint(0, self.num_timesteps, (img.shape[0],), generator=generator,
                              device=img.device)
        return self.p_losses(params, self.normalize(img), t, noise, generator, self_cond)

    # -- VLB / NLL -----------------------------------------------------------
    def _vb_terms_bpd(self, params, x_start, x_t, t: torch.Tensor, x_self_cond=None,
                      clip_denoised: bool = True, model_out=None):
        """Per-example VLB term at t: KL(q posterior || p) for t > 0, the
        decoder's negative log-likelihood at t = 0; mean over dims, nats."""
        if self.cfg.vlb_decoder == "density" or not self.cfg.vlb_clip_denoised:
            clip_denoised = False  # flow latents live outside [-1, 1]
        true_mean, _, true_logvar = self.q_posterior(x_start, x_t, t)
        model_mean, _, model_logvar, _ = self.p_mean_variance(
            params, x_t, t, x_self_cond, clip_denoised, model_out=model_out)
        kl = _mean_flat(normal_kl(true_mean, true_logvar, model_mean, model_logvar))
        if self.cfg.vlb_decoder == "density":
            # continuous Gaussian log-density at t = 0, its log-variance floored
            # at the t = 1 posterior's (the t = 0 posterior variance is 0)
            pv = self.sched.posterior_variance
            lv_floor = float(np.log(max(float(pv[min(1, len(pv) - 1)]), 1e-20)))
            dens_logvar = (torch.clamp(model_logvar, min=lv_floor)
                           if isinstance(model_logvar, torch.Tensor)
                           else max(model_logvar, lv_floor))
            decoder_nll = -_mean_flat(
                -0.5 * np.log(2.0 * np.pi) - 0.5 * dens_logvar
                - 0.5 * (x_start - model_mean) ** 2 * _exp(-dens_logvar))
        elif self.cfg.vlb_decoder == "discretized":
            decoder_nll = -_mean_flat(
                gaussian_log_likelihood(x_start, model_mean, 0.5 * model_logvar))
        else:
            raise ValueError(f"unknown vlb_decoder: {self.cfg.vlb_decoder!r} "
                             "(expected 'discretized' or 'density')")
        return torch.where(t == 0, decoder_nll, kl)

    def _prior_bpd(self, x_start):
        qt_mean, _, qt_logvar = self.q_mean_variance(x_start, self.num_timesteps - 1)
        return _mean_flat(normal_kl(qt_mean, qt_logvar, 0.0, 0.0))

    def neg_log_likelihood(self, params, x_start, generator: Optional[torch.Generator] = None,
                           noise: Optional[Sequence[torch.Tensor]] = None,
                           x_self_cond=None, clip_denoised: bool = True):
        """Full-T VLB per batch element: the sum over t of the mean-per-dim
        terms plus the prior term (per-dim nats, as the JAX package).

        `vlb_time_chunk` timesteps are folded into the batch of one model
        call, T-1 downwards, and the T % chunk remainder is one more call;
        each term is the one the sequential evaluation gives, since its noise
        is noise[t] (or the generator's next draw) either way."""
        b = x_start.shape[0]
        rest = x_start.shape[1:]
        chunk = max(1, int(self.cfg.vlb_time_chunk))
        ts = np.arange(self.num_timesteps - 1, -1, -1)
        if noise is None and generator is None:
            raise ValueError("neg_log_likelihood needs a generator or injected noise")
        vb_sum = torch.zeros((b,), dtype=torch.float32, device=x_start.device)
        for start in range(0, len(ts), chunk):
            ts_vec = ts[start:start + chunk]
            c = len(ts_vec)
            if noise is None:
                eps = torch.randn((c, *x_start.shape), generator=generator,
                                  device=x_start.device)
            else:
                eps = torch.stack([noise[t] for t in ts_vec])
            tb = torch.as_tensor(ts_vec if c == 1 else np.repeat(ts_vec, b),
                                 dtype=torch.int64, device=x_start.device)
            xs = x_start.expand(c, *x_start.shape).reshape(c * b, *rest)
            x_t = self.q_sample(xs, tb, eps.reshape(c * b, *rest))
            sc = None
            if x_self_cond is not None:
                sc = x_self_cond.expand(c, *x_self_cond.shape).reshape(c * b, *rest)
            vb = self._vb_terms_bpd(params, xs, x_t, tb, sc, clip_denoised)
            vb_sum = vb_sum + vb.reshape(c, b).sum(dim=0)
        return vb_sum + self._prior_bpd(x_start)
