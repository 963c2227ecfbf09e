"""Read a cell's checks over many seeds in one process, for setting its
limits: the program as it stands, the control (the program with its own
TF32 path switched on, model.training.matmul_precision=high: cuDNN and
cuBLAS in TF32, the configuration's fp32 being the precision below it), or
a planted fault (perfbench/tools/faults.py). Each seed builds the cell as a
run does, makes `--calls` calls at the cell's own sizes and runs the check.

    python3 perfbench/tools/readings.py --workload nfdp-cifar10.sample \
        --seeds 1,2,3 --calls 1 --mode program [--sweep] --out chiprun_out/r.jsonl

--sweep (stage-2 sampling): for the first call, every chain step of the
program beside the fp64 reference's and the fp32 reference's, latents and
pixels, to tell rounding from a fault. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench.bench import manifest  # noqa: E402
from perfbench.tools import faults  # noqa: E402


def seeds_of(text: str):
    return [int(s) for s in text.split(",") if s]


def _gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def sweep(cell, records) -> dict:
    """The first call's chain, step by step, against the references."""
    from perfbench.reference import diffusion as ref_diffusion
    from perfbench.reference import glow as ref_glow
    from perfbench.reference import unet as ref_unet

    u, d = cell.spec.config["unet"], cell.spec.config["diffusion"]
    gelu = cell.spec.config["time_mlp_gelu"]
    draws = cell._draws(0, cell.steps)
    out = {"parts": []}
    chains = {}
    for dt in (torch.float64, torch.float32):
        lat = []
        for part, (named, t) in enumerate(zip(cell.unet_params, draws)):
            P = {k: v.to(dt) for k, v in named.items()}
            rec = []
            with torch.no_grad():
                z = ref_diffusion.ddim_chain(
                    lambda x, tt: ref_unet.unet(P, x, tt, u["dim"], u["dim_mults"],
                                                u["resnet_block_groups"], gelu),
                    t.to(dt).unbind(0), d["timesteps"], cell.steps, d["ddim_sampling_eta"], rec)
            lat.append((z, rec))
        chains[dt] = lat
    for part in range(len(cell.parts)):
        prog = records[part] + [cell.latents[0][part].to(cell.device)]
        r64 = chains[torch.float64][part][1] + [chains[torch.float64][part][0]]
        r32 = chains[torch.float32][part][1] + [chains[torch.float32][part][0]]
        pg = [_gap(a, b) for a, b in zip(prog, r64)]
        rg = [_gap(a, b) for a, b in zip(r32, r64)]
        parted = next((j for j, (a, b) in enumerate(zip(pg, rg)) if a > 1e-6 and a > 4 * b),
                      None)
        out["parts"].append({"program_vs_fp64": pg[::10] + [pg[-1]],
                             "fp32_ref_vs_fp64": rg[::10] + [rg[-1]],
                             "latent_gap_program": pg[-1], "latent_gap_fp32_ref": rg[-1],
                             "first_step_program_4x_fp32_ref": parted})
    flow64 = ref_glow.cast(cell.flow, torch.float64)
    n_bits = cell.n_bits
    with torch.no_grad():
        def quantized(latents):
            x = ref_glow.inverse(flow64, [z.double() for z in latents])
            return torch.clamp(torch.floor((x + 0.5) * 2 ** n_bits) * (256 // 2 ** n_bits),
                               0, 255).to(torch.uint8)
        px64 = quantized([z for z, _ in chains[torch.float64]])
        px32 = quantized([z for z, _ in chains[torch.float32]])
    served = cell.served[0].to(cell.device)
    out["pixels_differ_program_vs_fp64"] = float((served != px64).float().mean())
    out["pixels_differ_fp32_ref_vs_fp64"] = float((px32 != px64).float().mean())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import nfdpm_tpu_torch as port

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    spec0 = manifest.load(args.workload)
    entry = manifest.entry_module(spec0.entry)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for seed in seeds_of(args.seeds):
        spec = manifest.load(args.workload)
        t0 = time.time()
        fault = args.mode.split(":", 1)[1] if args.mode.startswith("fault:") else None
        plant = faults.plant(fault, spec.entry) if fault else contextlib.nullcontext()
        records = None
        with plant:
            if args.mode == "control":
                port.set_matmul_precision("high")
            cell = entry.Cell(spec, seed, device)
            if args.sweep:
                records = [[] for _ in cell.parts]
                hooks = [m.register_forward_pre_hook(
                    lambda mod, a, k=i: records[k].append(a[0].detach().clone()))
                    for i, m in enumerate(cell.params["diffusion"]["parts"])]
            t1 = time.time()
            for i in range(args.calls):
                cell.call(i)
            if cuda:
                torch.cuda.synchronize(device)
            t2 = time.time()
            if args.sweep:
                for h in hooks:
                    h.remove()
                records = [r[:cell.steps] for r in records]
            port.set_matmul_precision(None)
        extra = {}
        if args.sweep:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            extra = sweep(cell, records)
            records = None
        cell.close()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        checks = cell.check()
        line = {"workload": args.workload, "seed": seed, "mode": args.mode,
                "calls": args.calls, "checks": checks, "setup_s": t1 - t0,
                "calls_s": t2 - t1, "check_s": time.time() - t2, **extra}
        if getattr(cell, "skipped", None) is not None:
            line["skipped_leaves"] = cell.skipped
            line["worst_leaves"] = cell.worst
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del cell
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
