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
torch's own error. ``--device-da on`` (on-device augmentation) is not ported
yet (ROADMAP M9).
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
                    help="seed the network with another run's checkpoint before training "
                         "(momentum and generator stay fresh; tensors of another shape keep "
                         "their initialization)")
    ap.add_argument("--device-da", choices=["auto", "on", "off"], default="auto",
                    help="augmentation on the device inside the train step (not ported yet: "
                         "auto means off)")
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' trains on the CPU in f32")
    args = ap.parse_args(argv)

    from nextou_tpu_torch.plans import load_dataset_json
    from nextou_tpu_torch.train import get_trainer_class

    plans_path = args.plans or os.path.join(args.dataset_folder, "nnUNetPlans.json")
    fold = args.fold if args.fold == "all" else int(args.fold)
    output = args.output or os.path.join(
        args.dataset_folder, f"{args.trainer}__{args.configuration}__fold_{fold}")
    trainer = get_trainer_class(args.trainer)(
        plans_path, args.configuration, fold, load_dataset_json(args.dataset_folder),
        preprocessed_folder=args.dataset_folder, output_folder=output, device=args.device,
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
