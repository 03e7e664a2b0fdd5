"""CLI: pick the best configuration or ensemble from cross-validation results.

Counterpart of ``nextou_tpu/find_best_configuration.py``, upstream's
``nnUNetv2_find_best_configuration``: read the ``validation/summary.json``
of each trained (trainer, configuration) run, optionally evaluate 2-way
ensembles of their saved probabilities, rank by foreground mean Dice,
decide the winner's largest-component postprocessing on its
cross-validation predictions, and write ``inference_information.json``
describing what to run at inference time. The JSON is the JAX package's,
key for key, but for the commands it names, which are the port's.

    python -m nextou_tpu_torch.find_best_configuration RUNS... [-o OUT.json] [-ds PREPROC]

where each RUN is a trainer output folder (containing
``validation/summary.json``) or a ``name=folder`` pair for labeling.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np

from nextou_tpu_torch.infer.evaluate import case_metrics, summarize_metrics
from nextou_tpu_torch.plans.loader import LabelManager, load_dataset_json
from nextou_tpu_torch.postprocess import determine_postprocessing


def read_fg_dice(run_folder: str) -> float:
    path = os.path.join(run_folder, "validation", "summary.json")
    with open(path) as f:
        return float(json.load(f)["foreground_mean"]["Dice"])


def _validation_npz(folder: str) -> dict[str, str]:
    """case id -> validation npz path for one run folder."""
    vdir = os.path.join(folder, "validation")
    if not os.path.isdir(vdir):
        return {}
    return {
        f[:-4]: os.path.join(vdir, f)
        for f in os.listdir(vdir)
        if f.endswith(".npz")
    }


def _validation_npz_with_probabilities(folder: str) -> dict[str, str]:
    """Only npz files that carry a softmax ('probabilities'): validation
    writes segs always and probabilities with --npz, so ensembling must
    filter (the zip directory read is cheap, no decompression)."""
    out = {}
    for cid, path in _validation_npz(folder).items():
        try:
            with np.load(path) as z:
                if "probabilities" in z.files:
                    out[cid] = path
        except (OSError, ValueError):
            continue
    return out


def _matching_gt(cid: str, shape, dataset_folder: str, cache: dict):
    """The preprocessed GT for ``cid`` whose (squeezed) spatial shape matches
    the prediction — cases may live flat or under several data_identifier
    subfolders (e.g. nnUNetPlans_2d/ AND nnUNetPlans_3d_fullres/); picking by
    shape instead of first-found prevents scoring against another
    configuration's grid."""
    if cid not in cache:
        cands = [os.path.join(dataset_folder, f"{cid}.npz")] + [
            os.path.join(dataset_folder, d, f"{cid}.npz")
            for d in sorted(os.listdir(dataset_folder))
            if os.path.isdir(os.path.join(dataset_folder, d))
        ]
        cache[cid] = [
            np.squeeze(np.load(p)["seg"])
            for p in cands
            if os.path.exists(p)
        ]
    want = tuple(s for s in shape if s != 1)
    for gt in cache[cid]:
        if gt.shape == want:
            return gt
    if not cache[cid]:
        raise FileNotFoundError(os.path.join(dataset_folder, f"{cid}.npz"))
    raise ValueError(
        f"no preprocessed GT for {cid} matches prediction shape "
        f"{tuple(shape)} (found {[g.shape for g in cache[cid]]})"
    )


def _ensemble_candidates(results: list[dict], dataset_folder: str) -> list[dict]:
    """Evaluate every 2-way ensemble of runs whose final validation saved
    probabilities (``nnUNetv2_train --npz``): average the two softmaxes per
    case, convert to labels, score against the preprocessed GT: nnU-Net's
    find_best ensembling step. Runs without npz files (or with
    disjoint case sets) are silently not paired; a pair that fails to
    evaluate (missing GT, mismatched grids, unreadable npz) is skipped with
    a message and never aborts the ranking of the other candidates.

    The loop runs case-outermost so each run's probabilities and each GT
    file are decompressed once per case, not once per pair (O(runs) loads
    instead of O(runs^2))."""

    def _eval_labels(lm):
        # region datasets rank by per-region Dice, like nnU-Net's find_best
        return lm.foreground_regions if lm.has_regions else lm.all_labels

    probmaps = {r["folder"]: _validation_npz_with_probabilities(r["folder"]) for r in results}
    pairs = []
    for a, b in itertools.combinations(results, 2):
        shared = set(probmaps[a["folder"]]) & set(probmaps[b["folder"]])
        if not shared:
            continue
        try:
            lm = LabelManager(load_dataset_json(a["folder"]))
        except (FileNotFoundError, KeyError) as e:
            print(
                f"skipping ensemble {a['name']} + {b['name']}: "
                f"no readable dataset.json in {a['folder']} ({e})"
            )
            continue
        pairs.append(
            {"a": a, "b": b, "shared": shared, "lm": lm, "metrics": [],
             "failed": None}
        )
    if not pairs:
        return []

    all_cids = sorted(set().union(*(p["shared"] for p in pairs)))
    for cid in all_cids:
        live = [p for p in pairs if p["failed"] is None and cid in p["shared"]]
        if not live:
            continue
        probs, gt_cache = {}, {}
        for p in live:
            try:
                for run in (p["a"], p["b"]):
                    f = run["folder"]
                    if f not in probs:
                        probs[f] = np.load(probmaps[f][cid])[
                            "probabilities"
                        ].astype(np.float32)
                avg = (probs[p["a"]["folder"]] + probs[p["b"]["folder"]]) / 2.0
                seg = p["lm"].convert_probabilities_to_segmentation(avg)
                gt = _matching_gt(cid, np.shape(seg), dataset_folder, gt_cache)
                p["metrics"].append(
                    {"case": cid,
                     "metrics": case_metrics(seg, gt, _eval_labels(p["lm"]))}
                )
            except Exception as e:  # noqa: BLE001 — isolate this pair only
                p["failed"] = f"case {cid}: {type(e).__name__}: {e}"

    out = []
    for p in pairs:
        name = f"ensemble {p['a']['name']} + {p['b']['name']}"
        if p["failed"] is not None:
            print(f"skipping {name}: {p['failed']}")
            continue
        if not p["metrics"]:
            continue
        summary = summarize_metrics(p["metrics"], _eval_labels(p["lm"]))
        out.append(
            {
                "name": name,
                "folder": [p["a"]["folder"], p["b"]["folder"]],
                "fg_mean_dice": summary["foreground_mean"]["Dice"],
            }
        )
    return out


def _winner_cv_cases(best: dict, dataset_folder: str):
    """(pred_seg, gt) pairs of the winner's cross-validation predictions.

    Single run: the segs validation always writes. Ensemble winner: average
    the two runs' saved softmaxes per shared case and convert to labels —
    postprocessing must be decided on exactly what inference will produce.
    Returns [] (with a message) when the artifacts don't exist (e.g. runs
    from before segs were stored, or an ensemble without --npz).
    """
    pairs, gt_cache = [], {}
    if isinstance(best["folder"], list):  # ensemble winner
        maps = [
            _validation_npz_with_probabilities(f) for f in best["folder"]
        ]
        shared = sorted(set(maps[0]) & set(maps[1]))
        if not shared:
            print(
                "postprocessing: skipped — ensemble winner has no shared "
                "validation probabilities"
            )
            return []
        lm = LabelManager(load_dataset_json(best["folder"][0]))
        for cid in shared:
            avg = sum(
                np.load(m[cid])["probabilities"].astype(np.float32)
                for m in maps
            ) / len(maps)
            seg = lm.convert_probabilities_to_segmentation(avg)
            pairs.append(
                (seg, _matching_gt(cid, seg.shape, dataset_folder, gt_cache))
            )
        return pairs
    for cid, path in sorted(_validation_npz(best["folder"]).items()):
        with np.load(path) as z:
            if "seg" not in z.files:
                print(
                    f"postprocessing: skipped — {path} has no 'seg' (rerun "
                    "validation with a current build to store CV segs)"
                )
                return []
            seg = np.squeeze(z["seg"])
        pairs.append(
            (seg, _matching_gt(cid, seg.shape, dataset_folder, gt_cache))
        )
    if not pairs:
        print(
            f"postprocessing: skipped — no validation npz in "
            f"{best['folder']}"
        )
    return pairs


def _determine_winner_postprocessing(
    best: dict, dataset_folder: str
) -> dict | None:
    """nnU-Net's find_best also decides largest-component postprocessing on
    the winner's CV predictions and bakes it into inference_information —
    do the same."""
    try:
        cases = _winner_cv_cases(best, dataset_folder)
    except (FileNotFoundError, ValueError, KeyError) as e:
        print(f"postprocessing: skipped ({type(e).__name__}: {e})")
        return None
    if not cases:
        return None
    labels = sorted(
        set().union(*(np.unique(gt).tolist() for _, gt in cases))
    )
    pp = determine_postprocessing(
        [(np.asarray(p, np.int32), np.asarray(g, np.int32))
         for p, g in cases],
        labels,
    )
    kept = [l for l, do in
            pp["remove_all_but_largest_component"].items() if do]
    print(
        "postprocessing: keep-largest-component for labels "
        f"{kept or 'none'} (decided on {len(cases)} CV cases)"
    )
    return pp


def find_best(runs: dict[str, str], dataset_folder: str | None = None) -> dict:
    """runs: name -> trainer output folder. With ``dataset_folder`` (the
    preprocessed GT), 2-way ensembles of saved validation probabilities
    join the ranking, and largest-component postprocessing is determined on
    the winner's CV predictions (nnU-Net's find_best workflow). Returns the
    ranking dict."""
    results = []
    for name, folder in runs.items():
        try:
            dice = read_fg_dice(folder)
        except FileNotFoundError:
            print(f"skipping {name}: no validation/summary.json in {folder}")
            continue
        results.append({"name": name, "folder": folder, "fg_mean_dice": dice})
    if not results:
        raise SystemExit("no run has a validation/summary.json")
    if dataset_folder is not None:
        results += _ensemble_candidates(results, dataset_folder)
    results.sort(key=lambda r: r["fg_mean_dice"], reverse=True)
    best = results[0]
    postprocessing = (
        _determine_winner_postprocessing(best, dataset_folder)
        if dataset_folder is not None
        else None
    )
    pp_helps = postprocessing is not None and any(
        postprocessing["remove_all_but_largest_component"].values()
    )
    pp_step = (
        " && python -m nextou_tpu_torch.postprocess apply <OUT> -o <OUT_pp> "
        "-pp postprocessing.json"
        if pp_helps
        else ""
    )
    if isinstance(best["folder"], list):  # a 2-way ensemble won
        steps = [
            f"python -m nextou_tpu_torch.predict {f} <DATA> <CONFIG> "
            f"-o <OUT_{i}> --save-probabilities"
            for i, f in enumerate(best["folder"])
        ]
        steps.append(
            "python -m nextou_tpu_torch.ensemble <OUT_0> <OUT_1> -o <OUT>"
        )
        instructions = " && ".join(steps) + pp_step
    else:
        instructions = (
            f"python -m nextou_tpu_torch.predict {best['folder']} <DATA> "
            "<CONFIG> -o <OUT>" + (
                pp_step or "  # no beneficial postprocessing determined"
            )
        )
    info = {
        "best_configuration": best["name"],
        "best_fg_mean_dice": best["fg_mean_dice"],
        "ranking": results,
        "inference_instructions": instructions,
    }
    if postprocessing is not None:
        info["postprocessing"] = postprocessing
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+",
                    help="trainer output folders (or name=folder)")
    ap.add_argument("-o", "--output", default="inference_information.json")
    ap.add_argument(
        "-ds", "--dataset-folder", default=None,
        help="preprocessed dataset folder (GT): also rank 2-way ensembles "
             "of runs that saved validation probabilities (train --npz)",
    )
    args = ap.parse_args(argv)

    runs = {}
    for r in args.runs:
        if "=" in r:
            name, folder = r.split("=", 1)
        else:
            name, folder = os.path.basename(os.path.normpath(r)), r
        runs[name] = folder

    info = find_best(runs, dataset_folder=args.dataset_folder)
    with open(args.output, "w") as f:
        json.dump(info, f, indent=2)
    if "postprocessing" in info:
        pp_path = os.path.join(
            os.path.dirname(os.path.abspath(args.output)),
            "postprocessing.json",
        )
        with open(pp_path, "w") as f:
            json.dump(info["postprocessing"], f, indent=2)
        print("postprocessing written:", pp_path)
    print(
        f"best: {info['best_configuration']} "
        f"(fg mean Dice {info['best_fg_mean_dice']:.4f})"
    )
    for r in info["ranking"]:
        print(f"  {r['fg_mean_dice']:.4f}  {r['name']}")
    print("written:", args.output)


if __name__ == "__main__":
    main()
