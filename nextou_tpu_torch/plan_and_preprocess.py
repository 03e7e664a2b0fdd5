"""CLI: fingerprint a raw dataset, plan the experiment, preprocess the cases.

Counterpart of ``nextou_tpu/plan_and_preprocess.py``, upstream's
``nnUNetv2_plan_and_preprocess``:

    python -m nextou_tpu_torch.plan_and_preprocess RAW_FOLDER -o PREPROC_FOLDER \\
        [-c 2d 3d_fullres ...] [--max-cases N] [--no-preprocess] \\
        [--verify_dataset_integrity] [--fingerprint-only]

RAW_FOLDER is in nnU-Net's raw layout: ``imagesTr/{case}_{0000..}.nii.gz``,
``labelsTr/{case}.nii.gz``, ``dataset.json``. Writes ``nnUNetPlans.json``,
``dataset.json`` (copied), ``dataset_fingerprint.json`` and one subfolder
of preprocessed ``.npz`` cases per configuration (named by its
data_identifier), ready for ``python -m nextou_tpu_torch.run_training``.
The same raw folder gives the same files, bit for bit, as the JAX
package's CLI.

Without ``-c`` every configuration with a ``patch_size`` and no
``previous_stage`` is preprocessed, as the JAX package does: an overlay
such as ``3d_fullres_nextou`` that sets a ``patch_size`` inherits its
parent's data_identifier and so writes the parent's cases a second time,
with the same content.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nextou_tpu_torch.data.dataset import save_case
from nextou_tpu_torch.data.io import read_image
from nextou_tpu_torch.data.preprocessing import preprocess_case
from nextou_tpu_torch.paths import resolve_raw
from nextou_tpu_torch.plans.fingerprint import extract_fingerprint
from nextou_tpu_torch.plans.integrity import verify_dataset_integrity
from nextou_tpu_torch.plans.loader import PlansManager
from nextou_tpu_torch.plans.planner import plan_experiment


def main_extract_fingerprint(argv=None):
    """``nnUNetv2_extract_fingerprint``: the fingerprint only."""
    return main((argv or sys.argv[1:]) + ["--fingerprint-only"])


def main_plan_experiment(argv=None):
    """``nnUNetv2_plan_experiment``: fingerprint and plans, no data."""
    return main((argv or sys.argv[1:]) + ["--no-preprocess"])


def preprocess_dataset(
    raw_folder: str,
    out_folder: str,
    plans: dict,
    dataset_json: dict,
    configurations: list[str],
    case_ids: list[str] | None = None,
    verbose: bool = True,
):
    """Crop, normalize and resample every case for each configuration into
    ``out_folder/<data_identifier>/``. One task per case, in a thread pool:
    a case's files depend on the case alone, not on which thread wrote
    them."""
    pm = PlansManager(plans)
    ending = dataset_json.get("file_ending", ".nii.gz")
    channels = dataset_json.get(
        "channel_names", dataset_json.get("modality", {"0": "noNorm"})
    )
    fwd = pm.transpose_forward or None
    intensity = plans.get("foreground_intensity_properties_per_channel", {})

    if case_ids is None:
        labels_dir = os.path.join(raw_folder, "labelsTr")
        case_ids = sorted(
            f[: -len(ending)]
            for f in os.listdir(labels_dir)
            if f.endswith(ending)
        )

    cfgs = []
    for config_name in configurations:
        cm = pm.get_configuration(config_name)
        dest = os.path.join(out_folder, cm.data_identifier or config_name)
        os.makedirs(dest, exist_ok=True)
        cfgs.append((config_name, cm, dest))

    def one_case(cid):
        # read (and gunzip) the raw volumes once, then preprocess them for
        # every configuration
        seg, _ = read_image(
            os.path.join(raw_folder, "labelsTr", f"{cid}{ending}")
        )
        # 4D-singleton volumes pass integrity and fingerprint (the same
        # squeeze there): no phantom spatial axis here either
        seg = seg[0] if seg.ndim == 4 else seg
        chans, spacing = [], None
        for c in range(len(channels)):
            arr, sp = read_image(
                os.path.join(raw_folder, "imagesTr", f"{cid}_{c:04d}{ending}")
            )
            chans.append(arr[0] if arr.ndim == 4 else arr)
            spacing = sp or spacing
        data = np.stack(chans)
        if not spacing:
            spacing = (1.0,) * seg.ndim
        spacing = list(spacing)
        if fwd and len(fwd) == seg.ndim:
            data = np.transpose(data, [0] + [f + 1 for f in fwd])
            seg = np.transpose(seg, fwd)
            spacing = [spacing[f] for f in fwd]
        for config_name, cm, dest in cfgs:
            # 2d configurations resample in plane only; the leading axis stays
            tgt = list(cm.spacing)
            if cm.spatial_dims == 2 and seg.ndim == 3:
                tgt = [spacing[0]] + tgt
            pdata, pseg, props = preprocess_case(
                data,
                seg,
                spacing,
                tgt,
                use_mask_for_norm=cm.use_mask_for_norm,
                normalization_schemes=cm.normalization_schemes,
                intensity_props=intensity,
                resampling_data_kwargs=cm.resampling_fn_data_kwargs,
                resampling_seg_kwargs=cm.resampling_fn_seg_kwargs,
            )
            save_case(dest, cid, pdata, pseg, properties=props)
            if verbose:
                print(f"[{config_name}] {cid}: {pdata.shape}", flush=True)

    # threads stand in for nnU-Net's preprocessing processes (numpy, scipy
    # and the native resampler release the GIL in the heavy parts)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        futures = [ex.submit(one_case, cid) for cid in case_ids]
        for f in futures:
            f.result()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("raw_folder", help="nnU-Net-raw-layout dataset folder")
    ap.add_argument("-o", "--output", required=True, help="preprocessed out")
    ap.add_argument(
        "-c", "--configurations", nargs="+", default=None,
        help="configurations to preprocess (default: all planned non-overlay)",
    )
    ap.add_argument("--max-cases", type=int, default=None)
    ap.add_argument("--no-preprocess", action="store_true",
                    help="plan only, skip preprocessing")
    ap.add_argument("--verify_dataset_integrity", action="store_true",
                    help="check the raw dataset (channels/labels/shapes/"
                         "spacings) before planning, like nnU-Net")
    ap.add_argument("--fingerprint-only", action="store_true",
                    help="stop after writing dataset_fingerprint.json "
                         "(the nnUNetv2_extract_fingerprint stage)")
    args = ap.parse_args(argv)

    args.raw_folder = resolve_raw(args.raw_folder)
    if args.verify_dataset_integrity:
        problems = verify_dataset_integrity(
            args.raw_folder, max_cases=args.max_cases
        )
        if problems:
            for p in problems:
                print(f"INTEGRITY: {p}")
            raise SystemExit(
                f"dataset integrity check failed ({len(problems)} problems)"
            )
        print("dataset integrity OK")

    with open(os.path.join(args.raw_folder, "dataset.json")) as f:
        dataset_json = json.load(f)

    print("extracting fingerprint ...")
    fp = extract_fingerprint(
        args.raw_folder, dataset_json, max_cases=args.max_cases
    )
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "dataset_fingerprint.json"), "w") as f:
        json.dump(fp, f, indent=2)
    if args.fingerprint_only:
        return

    print("planning experiment ...")
    plans = plan_experiment(
        fp, dataset_json,
        dataset_name=dataset_json.get("name", os.path.basename(
            os.path.normpath(args.raw_folder))),
    )
    with open(os.path.join(args.output, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f, indent=2)
    with open(os.path.join(args.output, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    for name, cfg in plans["configurations"].items():
        ps = cfg.get("patch_size")
        if ps:
            print(f"  {name}: patch {ps}, batch {cfg.get('batch_size')}")
        else:
            print(f"  {name}: inherits {cfg.get('inherits_from')}")

    if args.no_preprocess:
        return
    configs = args.configurations
    if configs is None:
        configs = [
            n for n, c in plans["configurations"].items()
            if "patch_size" in c and "previous_stage" not in c
        ]
    print(f"preprocessing {configs} ...")
    preprocess_dataset(
        args.raw_folder, args.output, plans, dataset_json, configs,
        case_ids=fp.get("case_ids"),
    )
    print("done:", args.output)


if __name__ == "__main__":
    main()
