"""Export CLI: a port checkpoint, a reference PyTorch TSM or TDN
checkpoint or a fresh init → a deployable ``.pt2`` artifact
(``utils/export.py``).

Port of ``workoutdetector_tpu/scripts/export_model.py``:

    python -m workoutdetector_tpu_torch.scripts.export_model \\
        --cfg workoutdetector_tpu/configs/repcount_12_tsm.yaml \\
        --checkpoint runs/ckpt/best -o model.pt2 [--batch 16] \\
        [--torch-ckpt tsm_sthv2.pth] [--cpu]

The artifact is exported for the card (its graph launches the hand
kernels), or with ``--cpu`` for the CPU, at the input shape
``models.example_input_shape`` gives (TDN's is rank 6);
``InferenceEngine.from_exported`` and ``engine_from_checkpoint`` load it
where this package is importable.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Export model for deployment")
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="port checkpoint file (CheckpointManager)")
    parser.add_argument("--torch-ckpt", default=None,
                        help="reference PyTorch TSM or TDN .pth to port "
                        "instead (TPN's backbone takes the TSM map)")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--batch", type=int, default=16,
                        help="window batch the artifact is exported for")
    parser.add_argument("--cpu", action="store_true",
                        help="export for the CPU (the kernels' plain versions)")
    parser.add_argument("opts", nargs="*")
    args = parser.parse_args(argv)

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.device import resolve_device
    from workoutdetector_tpu_torch.models import (build_model,
                                                  example_input_shape,
                                                  init_flax_variables,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.utils.export import export_model

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_config(args.cfg, args.opts)
    model = build_model(cfg.model)
    if args.checkpoint:
        from workoutdetector_tpu_torch.train.checkpoint import \
            CheckpointManager
        mgr = CheckpointManager(os.path.dirname(args.checkpoint) or ".")
        restored = mgr.restore_variables(args.checkpoint)
        model.load_state_dict({**restored["params"],
                               **restored["batch_stats"]})
    else:
        variables = init_flax_variables(model, seed=cfg.seed)
        if args.torch_ckpt:
            from workoutdetector_tpu_torch.models.convert import (
                load_torch_checkpoint, merge_into, port_tdn_checkpoint,
                port_tsm_checkpoint)
            port = port_tdn_checkpoint \
                if cfg.model.model_type.lower() == "tdn" else port_tsm_checkpoint
            tree = port(load_torch_checkpoint(args.torch_ckpt),
                        num_class=cfg.model.num_class,
                        target_params=variables["params"])
            variables = {"params": tree["params"],
                         "batch_stats": merge_into(variables["batch_stats"],
                                                   tree["batch_stats"])}
        load_flax_variables(model, variables)

    # TDN takes rank-6 bursts, TimeSformer its own model.image_size, the
    # others the data pipeline's crop
    shape = example_input_shape(cfg.model, batch=args.batch,
                                image_size=cfg.data.image_size)
    path = export_model(model, args.output, input_shape=shape, device=device,
                        meta={"model_type": cfg.model.model_type,
                              "num_class": cfg.model.num_class,
                              "checkpoint": args.checkpoint or args.torch_ckpt})
    print(f"exported to {path} (+ {path}.json)")


if __name__ == "__main__":
    main()
