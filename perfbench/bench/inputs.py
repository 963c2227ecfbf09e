"""The benchmark's inputs, made on the device from the seed: weights, images
and every random draw the program is handed. Each stream is a generator on
the run's device seeded from (seed, stream words), so the same seed gives
the same inputs and no two streams coincide. Weights come in a few large
draws per kind of leaf, in fp32, the dtype they are served in.

Scales: those of the port's own initialization (a Glow step's convolutions
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), its 1x1 convolution a random rotation
in PLU factors, then the trainer's data-dependent init of every actnorm; a
UNet's weights N(0, 1/fan_in)), and the leaves that initialization leaves
at zero or one moved by the seeded amounts of the configuration's
"assumed" block, so that no kernel sees trivial operands.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import glow as ref_glow

# first words of the generators' seeds, one per stream
FLOW, UNET, IMAGES, STEP_NOISE, CALL_NOISE, SAMPLE, DDINIT = 11, 12, 13, 14, 15, 16, 17


def generator(device, seed: int, *words: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, *words)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *map(int, words)])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return g


def _normal(g, shape, scale, device):
    return torch.randn(shape, generator=g, device=device) * scale


def _uniform(g, shape, bound, device):
    return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * bound


def level_channels(levels: int, channels: int) -> List[int]:
    """The channels the Glow steps of each level see: 3 -> [12, 24, 48]."""
    out, c = [], channels
    for _ in range(levels):
        c *= 4
        out.append(c)
        c //= 2
    return out


def glow_params(config: Dict, seed: int, device) -> Dict:
    """{"flow", "prior"}: the Glow of config["flow"] (L levels of K steps,
    coupling width, image channels), in the program's tree layout
    (perfbench/reference/glow.py), 4-D weights channels-last; with the
    configuration's data-dependent init, every actnorm set from a seeded
    batch. Made in full fp32 (TF32 off) whatever the process's setting."""
    with full_fp32():
        return _glow_params(config, seed, device)


@contextlib.contextmanager
def full_fp32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _glow_params(config: Dict, seed: int, device) -> Dict:
    f, a = config["flow"], config["assumed"]["moved_zero_init"]
    g = generator(device, seed, FLOW)
    width, k = f["coupling_width"], f["K"]
    chans = level_channels(f["L"], config["image"]["channels"])

    def cl(t):
        return t.contiguous(memory_format=torch.channels_last)

    def steps(c):
        w = torch.linalg.qr(torch.randn((k, c, c), generator=g, device=device,
                                        dtype=torch.float64))[0]
        p, lo, up = torch.linalg.lu(w)
        d = torch.diagonal(up, dim1=-2, dim2=-1)
        f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
        inv = {"p_mat": f32(p), "lower": f32(torch.tril(lo, -1)), "upper": f32(torch.triu(up, 1)),
               "log_s": f32(torch.log(d.abs())), "sign": f32(torch.sign(d))}
        conv1 = _uniform(g, (k, width, c // 2, 3, 3), (9 * c // 2) ** -0.5, device)
        conv2 = _uniform(g, (k, width, width, 1, 1), width ** -0.5, device)
        zw = _normal(g, (k, c, width, 3, 3), a["w"], device)
        vec_c = _normal(g, (k, 4, c), 1.0, device)        # actnorm scale, bias; zconv b, logs
        vec_w = _normal(g, (k, 4, width), 1.0, device)    # an1, an2 scale, bias
        out = []
        for i in range(k):
            out.append({
                "actnorm": {"scale": vec_c[i, 0] * a["scale"], "bias": vec_c[i, 1] * a["bias"]},
                "invconv": {n: t[i] for n, t in inv.items()},
                "coupling": {"net": {
                    "conv1": {"w": cl(conv1[i])},
                    "an1": {"scale": vec_w[i, 0] * a["scale"], "bias": vec_w[i, 1] * a["bias"]},
                    "conv2": {"w": cl(conv2[i])},
                    "an2": {"scale": vec_w[i, 2] * a["scale"], "bias": vec_w[i, 3] * a["bias"]},
                    "zconv": {"w": cl(zw[i]), "b": vec_c[i, 2] * a["b"],
                              "logs": vec_c[i, 3] * a["logs"]}}}})
        return out

    blocks = []
    for c in chans[:-1]:
        split = {"w": cl(_normal(g, (c, c // 2, 3, 3), a["w"], device)),
                 "b": _normal(g, (c,), a["b"], device), "logs": _normal(g, (c,), a["logs"], device)}
        blocks.append({"steps": steps(c), "split": {"conv": split}})
    top = 2 * chans[-1]
    prior = {"bias": _normal(g, (top,), a["bias"], device),
             "logs": _normal(g, (top,), a["logs"], device)}
    flow = {"blocks": blocks, "final_steps": steps(chans[-1])}
    n = config["assumed"].get("data_dependent_init_images", 0)
    if n:
        img = config["image"]
        gd = generator(device, seed, DDINIT)
        x = torch.randint(0, 256, (n, img["size"], img["size"], img["channels"]), generator=gd,
                          device=device).float() / 255.0
        x = ref_glow.preprocess(x, img["n_bits"]) + torch.rand(
            x.shape, generator=gd, device=device) / 2.0 ** img["n_bits"]
        data_dependent_init(flow, x)
    return {"flow": flow, "prior": prior}


def _stats(h: torch.Tensor):
    """The actnorm leaves that give h zero mean and unit variance per
    channel (Bessel-corrected std, eps 1e-6)."""
    dims = tuple(range(h.dim() - 1))
    return -torch.log(torch.std(h, dim=dims) + 1e-6), -torch.mean(h, dim=dims)


@torch.no_grad()
def data_dependent_init(flow: Dict, x: torch.Tensor) -> None:
    """Glow's data-dependent initialization, in place: every actnorm (the
    steps' and the coupling CNNs') set from the statistics of the batch x
    (dequantized codes) as the flow carries it, level by level, the
    zeroconvs as they are."""
    def steps(stack, y):
        for sp in stack:
            an, net = sp["actnorm"], sp["coupling"]["net"]
            an["scale"], an["bias"] = _stats(y)
            mixed = (torch.exp(an["scale"]) * (y + an["bias"])) @ ref_glow.weight(sp["invconv"]).T
            h = ref_glow.conv(ref_glow.halves(mixed)[0], net["conv1"]["w"], 1)
            net["an1"]["scale"], net["an1"]["bias"] = _stats(h)
            h = torch.relu(torch.exp(net["an1"]["scale"]) * (h + net["an1"]["bias"]))
            net["an2"]["scale"], net["an2"]["bias"] = _stats(ref_glow.conv(h, net["conv2"]["w"], 0))
            y, _ = ref_glow.step_forward(sp, y, torch.zeros(y.shape[0], dtype=y.dtype,
                                                            device=y.device))
        return y

    y = x
    for block in flow["blocks"]:
        y = steps(block["steps"], ref_glow.squeeze(y))
        y = ref_glow.halves(y)[0]
    steps(flow["final_steps"], ref_glow.squeeze(y))


def unet_params(shapes: Dict[str, tuple], config: Dict, seed: int, part: int,
                device) -> Dict[str, torch.Tensor]:
    """Part `part`'s UNet: every parameter of `shapes` (name -> shape, in
    order) from one draw. Weights N(0, 1/fan_in) (a conv's in x kh x kw, a
    dense layer's in, an attention matrix's rows); biases 0 and norm gains
    1, each moved by N(0, 1) times the configuration's assumed amount."""
    move = config["assumed"]["moved_unet_vectors"]
    g = generator(device, seed, UNET, part)
    flat = torch.randn(sum(int(np.prod(s)) for s in shapes.values()), generator=g,
                       device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        t = flat[at:at + n].reshape(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) == 1:
            base = 1.0 if leaf in ("g",) or name.endswith("norm.weight") else 0.0
            t = base + t * move
        elif len(shape) == 4:
            t = (t * (shape[1] * shape[2] * shape[3]) ** -0.5).contiguous(
                memory_format=torch.channels_last)
        elif leaf in ("w_qkv", "w_out"):
            t = t * shape[0] ** -0.5
        else:
            t = t * shape[1] ** -0.5
        out[name] = t
    return out


def images(n: int, size: int, channels: int, seed: int, device) -> np.ndarray:
    """n CIFAR-shaped uint8 images [n, size, size, channels] on the host,
    drawn on the device."""
    g = generator(device, seed, IMAGES)
    return torch.randint(0, 256, (n, size, size, channels), generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()


def step_noise(shape: Sequence[int], seed: int, step: int, device) -> torch.Tensor:
    """Train step `step`'s U(0, 1) dequantization draw."""
    return torch.rand(tuple(shape), generator=generator(device, seed, STEP_NOISE, step),
                      device=device)


def normal_parts(shapes: Sequence[Sequence[int]], seed: int, call: int,
                 device) -> List[torch.Tensor]:
    """Call `call`'s standard-normal draws, one tensor of each shape, from
    one draw split into contiguous parts."""
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, CALL_NOISE, call),
                       device=device)
    return [part.view(tuple(s)) for part, s in zip(flat.split(sizes), shapes)]
