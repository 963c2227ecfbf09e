#!/usr/bin/env python3
"""The coupling tails and the Glow step route around them, in any checkout
of the PyTorch port, on one CUDA card.

    python3 tools/profile_coupling_tails.py [--port DIR] [--label NAME]

Times the port found in DIR (default: this checkout) with this checkout's
chip_smoke.py helpers, so that two trees (this one and a `git archive` of
another commit, unpacked into a directory that .gitignore lists) are
measured by the same code; alternate them in one call. Batch 64, width 512,
seeded random weights, TF32 off:

  - "tail_kernels", at each level shape (16,16,12), (8,8,24), (4,4,48): the
    tail kernels alone, forward, backward and inverse, device us a launch
    (50 calls in a CUDA graph) and us (CUDA events). The step modes
    (coupling_step_tail, its backward, coupling_step_tail_inverse) where the
    port has them, else the plain-operand kernels on the half-width
    operands;
  - "step_route", at each level shape: one Glow step's kernel routes
    (bijectors.step_forward_kernels, step_inverse_kernels), the CUDA
    activities of the forward, of the forward and backward and of the
    inverse (torch.profiler), their device us, and the forward's and the
    inverse's device ms (CUDA graph);
  - "paths": Glow scoring of a batch of 64 (inference.make_eval_step, kernel
    route), the Glow's inverse of that batch's latents (glow.inverse, the
    sampling path's 12 inverse steps) and the stage-1 train step
    (nf_trainer.make_train_step from a ddinit'ed state,
    configs/nf_base.yaml), each: CUDA activities a call and their device
    ms; scoring's and the inverse's wall ms (20 synchronised calls); the train
    step's wall ms (median and spread of the last 16 of 20 synchronised
    steps) and busy share (device ms over the median).

One JSON line each, with the card's name and power limit; all lines also go
to chiprun_out/profile_coupling_tails[_NAME].json. Needs CUDA; builds the
port's flow kernels only; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tail_kernels(torch, cs, ct, emit):
    gen = torch.Generator(device="cuda").manual_seed(77)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    step_mode = hasattr(ct, "coupling_step_tail")
    inverse_step_mode = hasattr(ct, "coupling_step_tail_inverse")
    for h, w, c in cs.level_shapes():
        ldj0, g_ldj = randn(cs.BATCH, scale=10.0), randn(cs.BATCH)
        if step_mode:
            y, r = randn(cs.BATCH, h, w, c), randn(cs.BATCH, h, w, c, scale=0.5)
            zb, zlogs, g_out = randn(c, scale=0.2), randn(c, scale=0.2), randn(cs.BATCH, h, w, c)

            def fwd():
                return ct.coupling_step_tail(y, r, zb, zlogs, ldj0)

            def bwd():
                return ct.coupling_step_tail_bwd(y, r, zb, zlogs, g_out, g_ldj)
        else:
            half = (cs.BATCH, h, w, c // 2)
            ls, bias, xb, g_y = randn(*half, scale=0.5), randn(*half), randn(*half), randn(*half)

            def fwd():
                return ct.coupling_tail(ls, bias, xb)

            def bwd():
                return ct.coupling_tail_bwd(ls, bias, xb, g_y, g_ldj)
        y_i, r_i = randn(cs.BATCH, h, w, c), randn(cs.BATCH, h, w, c, scale=0.5)
        zb_i, zlogs_i = randn(c, scale=0.2), randn(c, scale=0.2)
        half = (cs.BATCH, h, w, c // 2)
        ls_i, bias_i = randn(*half, scale=0.5), randn(*half)
        yb_i = y_i[..., c // 2:].contiguous()

        def inv():
            if inverse_step_mode:
                return ct.coupling_step_tail_inverse(y_i, r_i, zb_i, zlogs_i)
            return ct.coupling_tail_inverse(ls_i, bias_i, yb_i)

        emit({"phase": "tail_kernels", "x": [cs.BATCH, h, w, c],
              "mode": "step" if step_mode else "plain operands",
              "inverse_mode": "step" if inverse_step_mode else "plain operands",
              "fwd_device_us": cs.graph_ms(fwd) * 1e3, "fwd_us": cs.cuda_ms(fwd) * 1e3,
              "bwd_device_us": cs.graph_ms(bwd) * 1e3, "bwd_us": cs.cuda_ms(bwd) * 1e3,
              "inv_device_us": cs.graph_ms(inv) * 1e3, "inv_us": cs.cuda_ms(inv) * 1e3})


def step_route(torch, cs, emit):
    from nfdpm_tpu_torch.convert import is_frozen_path, named_leaves
    from nfdpm_tpu_torch.ops import bijectors as bj

    gen = torch.Generator(device="cuda").manual_seed(78)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for h, w, c in cs.level_shapes():
        params = cs.random_step(torch, bj, c, cs.WIDTH, seed=c)
        x, ldj0 = randn(cs.BATCH, h, w, c), randn(cs.BATCH, scale=10.0)
        with torch.no_grad():
            def fwd():
                return bj.step_forward_kernels(params, x, ldj0)

            def inv():
                return bj.step_inverse_kernels(params, x)

            seq = cs.kernel_events(torch, fwd)
            fwd_device_ms = cs.graph_ms(fwd)
            seq_inv = cs.kernel_events(torch, inv)
            inv_device_ms = cs.graph_ms(inv)
        leaves = [leaf.requires_grad_(True) for path, leaf in named_leaves(params)
                  if not is_frozen_path(path)]
        xg = x.clone().requires_grad_(True)
        gy, gl = randn(cs.BATCH, h, w, c), randn(cs.BATCH)

        def fwd_bwd():
            y, ldj = bj.step_forward_kernels(params, xg, ldj0)
            return torch.autograd.grad((y, ldj), leaves + [xg], (gy, gl))

        seq_fb = cs.kernel_events(torch, fwd_bwd)
        emit({"phase": "step_route", "x": [cs.BATCH, h, w, c], "width": cs.WIDTH,
              "fwd_activities": len(seq), "fwd_profiler_device_us": sum(us for _, us in seq),
              "fwd_device_ms": fwd_device_ms, "fwd_bwd_activities": len(seq_fb),
              "fwd_bwd_profiler_device_us": sum(us for _, us in seq_fb),
              "inv_activities": len(seq_inv),
              "inv_profiler_device_us": sum(us for _, us in seq_inv),
              "inv_device_ms": inv_device_ms,
              "fwd_kernels": cs.short_names(seq), "fwd_bwd_kernels": cs.short_names(seq_fb),
              "inv_kernels": cs.short_names(seq_inv)})


def paths(torch, np, cs, emit):
    from nfdpm_tpu_torch import inference
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.models import prior as prior_m
    from nfdpm_tpu_torch.training import nf_trainer as nft

    device = torch.device("cuda")
    cfg, tcfg = cs.train_configs()
    params = {"flow": glow_m.init_glow(0, cfg, device),
              "prior": prior_m.init_gaussian_prior(glow_m.final_channels(cfg), True, device)}
    cs.randomize_zero_leaves(torch, params, seed=1)
    rng = np.random.default_rng(2)
    batches = [torch.from_numpy(rng.integers(0, 256, (cs.BATCH, cs.IMG, cs.IMG, 3))
                                .astype(np.float32) / 255.0).to(device) for _ in range(4)]
    noise = torch.rand(batches[0].shape, generator=torch.Generator(device="cuda").manual_seed(3),
                       device=device)
    eval_k = inference.make_eval_step(cfg, cs.N_BITS, device=device)

    def score():
        return eval_k(params, batches[0], noise=noise)

    seq = cs.kernel_events(torch, score)
    score_wall = cs.host_ms(torch, score, iters=20)
    score_device = sum(us for _, us in seq) / 1e3
    with torch.inference_mode():
        latents, _, _ = glow_m.forward(params["flow"], cfg, batches[0])

    def invert():
        with torch.inference_mode():
            return glow_m.inverse(params["flow"], cfg, latents)

    seq_inv = cs.kernel_events(torch, invert)
    inv_wall = cs.host_ms(torch, invert, iters=20)
    inv_device = sum(us for _, us in seq_inv) / 1e3

    tx = nft.optimizer_of(tcfg)
    state = nft.init_train_state(cs.TRAIN_SEED, cfg, tcfg, tx, device=device)
    state = nft.ddinit_train_state(state, cfg, tcfg, tx, batches[0])
    train_step = nft.make_train_step(cfg, tcfg, tx, device=device)
    walls = []
    for i in range(cs.TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = train_step(state, batches[i % len(batches)], cs.TRAIN_SEED)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    last16 = sorted(walls[-16:])
    median = (last16[7] + last16[8]) / 2
    holder = [state]

    def one_step():
        holder[0] = train_step(holder[0], batches[1], cs.TRAIN_SEED)[0]

    seq_t = cs.kernel_events(torch, one_step)
    step_device = sum(us for _, us in seq_t) / 1e3
    emit({"phase": "paths", "batch": cs.BATCH,
          "scoring_activities": len(seq), "scoring_device_ms": score_device,
          "scoring_wall_ms": score_wall, "scoring_busy_share": score_device / score_wall,
          "inverse_activities": len(seq_inv), "inverse_device_ms": inv_device,
          "inverse_wall_ms": inv_wall,
          "train_step_activities": len(seq_t), "train_step_device_ms": step_device,
          "train_step_wall_ms_median_last16": median,
          "train_step_wall_ms_min_max_last16": [last16[0], last16[-1]],
          "train_step_busy_share": step_device / median})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=Path, default=ROOT,
                    help="checkout whose nfdpm_tpu_torch is measured")
    ap.add_argument("--label", default="", help="names the run in its lines and file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_coupling_tails: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's measuring code

    sys.path.insert(0, str(args.port.resolve()))  # ahead of ROOT: the port measured
    import nfdpm_tpu_torch as port
    from nfdpm_tpu_torch.ops.kernels import _build as build
    from nfdpm_tpu_torch.ops.kernels import coupling_tail as ct

    port.disable_tf32()
    build.build(["flow_kernels"])
    card = cs.nvidia_smi()
    records = []

    def emit(record):
        record = {"label": args.label, "port": str(Path(port.__file__).parent), "card": card,
                  **record}
        records.append(record)
        print(json.dumps(record), flush=True)

    tail_kernels(torch, cs, ct, emit)
    step_route(torch, cs, emit)
    paths(torch, np, cs, emit)
    out = ROOT / "chiprun_out" / (f"profile_coupling_tails_{args.label}.json" if args.label
                                  else "profile_coupling_tails.json")
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
