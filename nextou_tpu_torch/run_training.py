"""CLI: train a model with the port, counterpart of ``nextou_tpu/run_training.py``
and of the reference's ``nnUNetv2_train DATASET CONFIG FOLD -tr TRAINER``:

    python -m nextou_tpu_torch.run_training DATASET_FOLDER CONFIG FOLD \\
        -tr nnUNetTrainer_NexToU_BTI_Synapse [-p plans.json] [--c] [--device cuda]

DATASET_FOLDER holds the preprocessed ``{case}.npz`` cases, ``dataset.json``
and (unless ``-p`` names another) ``nnUNetPlans.json``. The output folder
(``DATASET_FOLDER/{trainer}__{config}__fold_{fold}`` unless ``-o``) gets
``training_log.txt``, ``checkpoint_{best,final}.pth`` (``checkpoint_latest.pth``
every 50 epochs) and ``validation/summary.json``;
``python -m nextou_tpu_torch.predict`` serves ``checkpoint_final.pth``.

Trains on the card (``--device cuda``, the default) unless ``--device cpu``
asks for the CPU; without a card and without that option it fails with
torch's own error. ``--device-da`` picks where the augmentation runs:
``on`` draws each sample's plan in the loader threads and augments on the
device inside the train step (``data/device_augment.py``; on the CPU with
``--device cpu``), ``off`` augments on the host (``data/augment.py``), and
``auto`` (the default) is on for the card and off on the CPU. A cascade
configuration keeps host augmentation either way. Both give the same
batches for one seed, within float rounding.

Data parallel: under ``torch.distributed.run`` each process is one rank
(``parallel/distributed.py``); it joins the process group its launcher
describes, trains on its own card (``cuda:LOCAL_RANK``), or on the CPU with
``--device cpu``, with its share of the global ``--batch-size``, and leaves
the group at the end. Only rank 0 writes. Two ranks on the CPU::

    python -m torch.distributed.run --nproc_per_node 2 -m nextou_tpu_torch.run_training \
        DATASET_FOLDER 2d_tiny 0 --device cpu --epochs 1 --iters 2
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Run the CLI; returns the trainer."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset_folder", help="preprocessed dataset folder")
    ap.add_argument("configuration", help="e.g. 3d_fullres_nextou")
    ap.add_argument("fold", help="0-4 or 'all'")
    ap.add_argument("-tr", "--trainer", default="nnUNetTrainer_NexToU")
    ap.add_argument("-p", "--plans", default=None, help="plans json path")
    ap.add_argument("-o", "--output", default=None, help="output folder")
    ap.add_argument("--c", "--continue", dest="resume", action="store_true",
                    help="resume from checkpoint_latest.pth")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="instead of training, write a torch.profiler trace of N steps")
    ap.add_argument("--val", action="store_true",
                    help="skip training: load checkpoint_final.pth and run the final "
                         "validation (sliding-window prediction + summary.json)")
    ap.add_argument("--npz", action="store_true",
                    help="save each validation case's probabilities in validation/{case}.npz")
    ap.add_argument("-pretrained_weights", "--pretrained-weights", default=None, metavar="CKPT",
                    help="seed the network with another run's checkpoint (a .pth, or a "
                         "nextou_tpu .ckpt) before training "
                         "(momentum and generator stay fresh; tensors of another shape keep "
                         "their initialization)")
    ap.add_argument("--device-da", choices=["auto", "on", "off"], default="auto",
                    help="augmentation on the device inside the train step: on, off (on "
                         "the host), or auto (on for the card, off on the CPU and for a cascade)")
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' trains on the CPU in f32")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from nextou_tpu_torch.parallel import initialize_distributed, launched, rank_device

    # a launched rank joins its group here and leaves it at the end; a group
    # that the caller made stays the caller's
    own_group = launched() and not dist.is_initialized()
    if own_group:
        initialize_distributed(args.device)
    try:
        return _train(args, rank_device(args.device))
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, device):
    from nextou_tpu_torch.plans import load_dataset_json
    from nextou_tpu_torch.train import get_trainer_class

    plans_path = args.plans or os.path.join(args.dataset_folder, "nnUNetPlans.json")
    fold = args.fold if args.fold == "all" else int(args.fold)
    output = args.output or os.path.join(
        args.dataset_folder, f"{args.trainer}__{args.configuration}__fold_{fold}")
    trainer = get_trainer_class(args.trainer)(
        plans_path, args.configuration, fold, load_dataset_json(args.dataset_folder),
        preprocessed_folder=args.dataset_folder, output_folder=output, device=device,
        num_epochs=args.epochs, num_iterations_per_epoch=args.iters, batch_size=args.batch_size,
        device_da={"auto": "auto", "on": True, "off": False}[args.device_da],
    )
    if args.pretrained_weights:
        trainer.load_pretrained_weights(args.pretrained_weights)
    latest = os.path.join(output, "checkpoint_latest.pth")
    if args.resume:
        if os.path.exists(latest):
            trainer.load_checkpoint(latest)
        else:
            print(f"WARNING: --c requested but {latest} does not exist (checkpoint_latest is "
                  "written every 50 epochs); starting from scratch")
    if args.profile:
        trainer.profile_steps(args.profile)
        return trainer
    if args.val:
        trainer.load_checkpoint(os.path.join(output, "checkpoint_final.pth"))
    else:
        trainer.run_training()
    trainer.perform_actual_validation(save_probabilities=args.npz)
    return trainer


if __name__ == "__main__":
    main()
