"""Stats precompute command line.

Counterpart of nfdpm_tpu/metrics/precompute_stats.py: FID/KID feature
statistics of each dataset split over {legacy_tensorflow, clean} x
{inception_v3, clip_vit_b_32}, skipping files that exist; `--action clean`
removes every stats file of the directory.

    python -m nfdpm_tpu_torch.metrics.precompute_stats --action precompute \\
        --data_root ./datasets --datasets celeba imagenet32 [--device cpu]
    python -m nfdpm_tpu_torch.metrics.precompute_stats --action clean

The feature nets run on the CUDA card unless `--device cpu` is given;
`--data-parallel` runs a replica on every visible CUDA device (or the one
--device names) and splits each feature batch across them, in one process
(the same statistics as one device).
"""

from __future__ import annotations

import argparse
import logging

from . import fid as fid_m
from .compute import precompute_statistics

DEFAULT_PLAN = {
    # dataset: [(split, res), ...]
    "celeba": [("train", 224), ("test", 224)],
    "imagenet32": [("train", 32), ("val", 32)],
    "imagenet64": [("train", 64), ("val", 64)],
    "cifar10": [("train", 32), ("test", 32)],
    "MNIST": [("train", 32), ("test", 32)],
}
MODES = ["legacy_tensorflow", "clean"]
MODELS = ["inception_v3", "clip_vit_b_32"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--action", choices=["precompute", "clean"], required=True)
    p.add_argument("--data_root", default="./datasets")
    p.add_argument("--datasets", nargs="*", default=["celeba", "imagenet32", "imagenet64"])
    p.add_argument("--modes", nargs="*", default=MODES)
    p.add_argument("--models", nargs="*", default=MODELS)
    p.add_argument("--stats_dir", default=None,
                   help="default: NFDPM_TPU_STATS_DIR, else ~/.nfdpm_tpu/stats")
    p.add_argument("--limit", type=int, default=None,
                   help="cap the number of source images (smoke runs)")
    p.add_argument("--device", default=None, help="cpu to run off the card")
    p.add_argument("--data-parallel", action="store_true",
                   help="a feature net on every visible CUDA device, each batch split "
                        "across them")
    args = p.parse_args(argv)
    mesh = None
    if args.data_parallel and args.action == "precompute":
        from ..parallel.mesh import local_mesh, visible_devices

        mesh = local_mesh(visible_devices(args.device))

    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("precompute_stats")

    if args.action == "clean":
        fid_m.remove_all_stats(args.stats_dir)
        logger.info(f"Cleaned stats dir {args.stats_dir or fid_m.default_stats_dir()}")
        return

    for name in args.datasets:
        for split, res in DEFAULT_PLAN.get(name, [("train", 32)]):
            for mode in args.modes:
                for model in args.models:
                    logger.info(f"precompute {name} {split}@{res} {mode} {model}")
                    precompute_statistics(logger, args.data_root, name, split, res, mode,
                                          model, stats_dir=args.stats_dir, limit=args.limit,
                                          device=args.device, mesh=mesh)


if __name__ == "__main__":
    main()
