"""Train/test CLI of the port:

    python -m workoutdetector_tpu_torch.trainer --cfg <yaml> [--cpu] [opts]

the counterpart of ``python -m workoutdetector_tpu.trainer``: the same
flags and dotted config overrides (``model.num_class=12``). It trains on
the card; ``--cpu`` runs on the CPU (the kernels' plain versions). Under
a launcher (``torchrun --nproc-per-node N -m
workoutdetector_tpu_torch.trainer ...``) the ranks join one process group
and train data-parallel over a mesh from ``parallel.*``; rank 0 prints.
"""

from __future__ import annotations

import argparse

from workoutdetector_tpu_torch.config import load_config


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train a workout model")
    parser.add_argument("--cfg", dest="cfg_file", default=None,
                        help="Path to the config yaml")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dotted config overrides, e.g. model.num_class=12")
    args = parser.parse_args(argv)
    # REMAINDER swallows a flag that follows the first override
    if "--cpu" in args.opts:
        args.opts = [o for o in args.opts if o != "--cpu"]
        args.cpu = True
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = load_config(args.cfg_file, [o for o in args.opts if o])
    from workoutdetector_tpu_torch.train.trainer import test, train
    device = "cpu" if args.cpu else "cuda"
    history = train(cfg, device) if cfg.train else test(cfg, device)
    from workoutdetector_tpu_torch.parallel.distributed import is_main_process
    if is_main_process():
        print({k: round(float(v), 4) for k, v in history.items()})


if __name__ == "__main__":
    main()
