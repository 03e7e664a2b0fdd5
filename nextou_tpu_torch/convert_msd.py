"""CLI: convert a Medical Segmentation Decathlon dataset to nnU-Net's raw
layout, counterpart of ``nextou_tpu/convert_msd.py`` (upstream's
``nnUNetv2_convert_MSD_dataset``).

MSD ships ``imagesTr/{case}.nii.gz`` (4D when multi-modal) and a
dataset.json with ``modality``/``labels`` keyed the old way; nnU-Net's raw
layout wants one file per channel (``{case}_{0000..}.nii.gz``) and a
v2-style dataset.json (``channel_names``, ``file_ending``, labels as
name -> value). It writes the same files as the JAX package's CLI.

    python -m nextou_tpu_torch.convert_msd MSD_FOLDER -o OUT_FOLDER
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nextou_tpu_torch.data.io import read_nifti, write_nifti


def convert_msd_dataset(msd_folder: str, out_folder: str, verbose=True):
    with open(os.path.join(msd_folder, "dataset.json")) as f:
        dj = json.load(f)

    modality = dj.get("modality", dj.get("channel_names", {"0": "unknown"}))
    n_ch = len(modality)
    labels_in = dj.get("labels", {})
    # MSD: {"0": "background", ...} (value->name); v2 wants name->value
    if labels_in and all(str(k).lstrip("-").isdigit() for k in labels_in):
        labels = {str(v): int(k) for k, v in labels_in.items()}
    else:
        labels = labels_in

    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        src = os.path.join(msd_folder, sub)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(out_folder, sub)
        os.makedirs(dst, exist_ok=True)
        for fname in sorted(os.listdir(src)):
            if not fname.endswith(".nii.gz") or fname.startswith("."):
                continue
            case = fname[: -len(".nii.gz")]
            path = os.path.join(src, fname)
            if sub == "labelsTr":
                arr, sp = read_nifti(path)
                write_nifti(
                    os.path.join(dst, fname), arr.astype(np.int16), spacing=sp
                )
            else:
                arr, sp = read_nifti(path)
                if arr.ndim == 4:  # (x, y, z, C) MSD multi-modal
                    chans = [arr[..., c] for c in range(arr.shape[-1])]
                else:
                    chans = [arr]
                assert len(chans) == n_ch, (case, arr.shape, n_ch)
                for c, ch in enumerate(chans):
                    write_nifti(
                        os.path.join(dst, f"{case}_{c:04d}.nii.gz"),
                        ch, spacing=sp[:3],
                    )
            if verbose:
                print(f"[{sub}] {case}")

    out_dj = {
        "name": dj.get("name", os.path.basename(os.path.normpath(msd_folder))),
        "channel_names": {str(k): v for k, v in modality.items()},
        "labels": labels,
        "numTraining": dj.get("numTraining", 0),
        "file_ending": ".nii.gz",
    }
    with open(os.path.join(out_folder, "dataset.json"), "w") as f:
        json.dump(out_dj, f, indent=2)
    return out_dj


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("msd_folder")
    ap.add_argument("-o", "--output", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    dj = convert_msd_dataset(args.msd_folder, args.output)
    print("labels:", dj["labels"])
    print("done:", args.output)


if __name__ == "__main__":
    main()
