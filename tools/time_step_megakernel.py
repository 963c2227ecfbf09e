#!/usr/bin/env python3
"""The whole-step megakernel and the Glow step route it would replace, in any
checkout of the PyTorch port, on one CUDA card.

    python3 tools/time_step_megakernel.py [--port DIR] [--label NAME]

Times the port found in DIR (default: this checkout) with this checkout's
chip_smoke.py helpers, so that two trees (this one and a `git archive` of
another commit, unpacked into a directory that .gitignore lists) are
measured by the same code; alternate them in one call. Batch 64, width 512,
seeded random weights (chip_smoke.random_step), TF32 off:

  - "megakernel", at each level shape (16,16,12), (8,8,24), (4,4,48): the
    kernel alone (`launch` on weights packed once; device ms a launch from
    10 launches in a CUDA graph, ms from CUDA events), the route the Glow
    runs (bijectors.step_forward_kernels) and the step through the
    megakernel (bijectors.step_forward_megakernel) the same way, the plan,
    and the y and ldj gaps to the plain version;
  - "megakernel_glow": chip_smoke.py phase 21's chained scoring forward
    (every step through the megakernel) against glow.forward's kernel route
    on one batch of 64, device ms (CUDA graph) and wall ms.

One JSON line each, with the card's name and power limit; all lines also go
to chiprun_out/time_step_megakernel[_NAME].json. Needs CUDA; builds the
port's step_megakernel and flow kernels only; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def megakernel(torch, cs, sm, bj, emit):
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for h, w, c in cs.level_shapes():
        b, d = cs.BATCH, cs.WIDTH
        params = cs.random_step(torch, bj, c, d, seed=b + c)
        wf, bf, _ = bj.fold_actnorm_invconv(params["actnorm"], params["invconv"])
        net = params["coupling"]["net"]
        x = torch.randn((b, h, w, c), generator=gen, device="cuda")
        ldj0 = torch.zeros((b,), device="cuda")
        with torch.no_grad():
            packed = sm.pack(wf, bf, net, c)
            y, ldj = sm.launch(x, packed, d)
            y_p, ldj_p = sm.step_megakernel_forward_plain(x, wf, bf, net)
            fns = {"kernel": lambda: sm.launch(x, packed, d),
                   "route": lambda: bj.step_forward_kernels(params, x, ldj0),
                   "step": lambda: bj.step_forward_megakernel(params, x, ldj0)}
            times = {}
            for key, fn in fns.items():
                times[f"{key}_device_ms"] = cs.graph_ms(fn, calls=10, replays=10)
                times[f"{key}_ms"] = cs.cuda_ms(fn, iters=50, warmup=5)
        emit({"phase": "megakernel", "x": [b, h, w, c], "width": d,
              "plan": sm.plan(b, h, w, c, d)._asdict(),
              "y_max_abs_err": float((y - y_p).abs().max()),
              "ldj_max_abs_err": float((ldj - ldj_p).abs().max()), **times})


def megakernel_glow(torch, np, cs, bj, emit):
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.ops import quantize as q

    device = torch.device("cuda")
    cfg = glow_m.GlowConfig(levels=cs.LEVELS, steps=cs.STEPS, coupling_width=cs.WIDTH)
    flow = glow_m.init_glow(0, cfg, device)
    cs.randomize_zero_leaves(torch, {"flow": flow}, seed=1)
    imgs = np.random.default_rng(2).integers(0, 256, (cs.BATCH, cs.IMG, cs.IMG, 3),
                                             dtype=np.uint8)
    batch = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(device)
    noise = torch.rand(batch.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                       device=device)
    x = q.dequantize(None, q.preprocess(batch, cs.N_BITS), cs.N_BITS, noise)

    def chained():
        with torch.inference_mode():
            return cs.megakernel_glow_forward(bj, flow, x)

    def route():
        with torch.inference_mode():
            return glow_m.forward(flow, cfg, x)

    times = {}
    for key, fn in (("megakernel", chained), ("kernel_route", route)):
        times[f"{key}_device_ms"] = cs.graph_ms(fn, calls=3, replays=5)
        times[f"{key}_wall_ms"] = cs.host_ms(torch, fn)
    emit({"phase": "megakernel_glow", "batch": cs.BATCH, **times})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=Path, default=ROOT,
                    help="checkout whose nfdpm_tpu_torch is measured")
    ap.add_argument("--label", default="", help="names the run in its lines and file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_step_megakernel: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's measuring code

    sys.path.insert(0, str(args.port.resolve()))  # ahead of ROOT: the port measured
    import nfdpm_tpu_torch as port
    from nfdpm_tpu_torch.ops import bijectors as bj
    from nfdpm_tpu_torch.ops.kernels import _build as build
    from nfdpm_tpu_torch.ops.kernels import step_megakernel as sm

    port.disable_tf32()
    build.build(["flow_kernels", "step_megakernel"])
    card = cs.nvidia_smi()
    records = []

    def emit(record):
        record = {"label": args.label, "port": str(Path(port.__file__).parent), "card": card,
                  **record}
        records.append(record)
        print(json.dumps(record), flush=True)

    megakernel(torch, cs, sm, bj, emit)
    megakernel_glow(torch, np, cs, bj, emit)
    out = ROOT / "chiprun_out" / (f"time_step_megakernel_{args.label}.json" if args.label
                                  else "time_step_megakernel.json")
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
