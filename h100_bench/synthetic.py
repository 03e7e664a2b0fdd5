"""The benchmark's inputs, made from the run's seed: one general generator
per kind of image, driven by a traffic file's parameters.

- ``ct``: CT-like volumes whose labels are the regions of a coarse random
  partition (16 x 40 x 40 voxels a cell, every class drawn), the intensity
  the label's level plus Gaussian noise (sd 0.3), made on the device;
- ``retina``: RAVIR-like infrared images (768 x 768): veins, then arteries
  over them, as a few bent chords across the field, 3-7 px wide, so that
  they cross; arteries bright, veins dark, noise; z-scored as nnU-Net's
  preprocessing leaves them.

``write_dataset`` lays labelled cases out as nnU-Net's preprocessing does:
one uncompressed ``.npz`` per case (``data`` (C, *sp) f32, ``seg`` int16,
``fg_<class>`` up to 10,000 foreground coordinates per class).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

FG_LOCATIONS = 10_000


def ct_cases(seed: int, n: int, shape, num_classes: int, device) -> list:
    """``[(data (*shape) f32, seg (*shape) int16)]`` as device tensors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cell = (16, 40, 40)
    coarse_shape = [-(-s // c) for s, c in zip(shape, cell)]
    out = []
    for _ in range(n):
        coarse = torch.randn(num_classes, *coarse_shape, generator=gen, device=device)
        seg = coarse.argmax(0)
        for axis, c in enumerate(cell):
            seg = seg.repeat_interleave(c, dim=axis)
        seg = seg[tuple(slice(0, s) for s in shape)].contiguous().to(torch.int16)
        noise = torch.randn(*shape, generator=gen, device=device) * 0.3
        data = seg.float() / (num_classes - 1) - 0.5 + noise
        out.append((data, seg))
    return out


def vessel_map(rng, shape) -> np.ndarray:
    H, W = shape
    seg = np.zeros(shape, np.int16)
    for label in (2, 1):
        for _ in range(int(rng.integers(4, 7))):
            a, b = rng.uniform(0, 2 * np.pi, 2)
            p0 = np.array([H / 2 + 0.6 * H * np.sin(a), W / 2 + 0.6 * W * np.cos(a)])
            p1 = np.array([H / 2 + 0.6 * H * np.sin(b), W / 2 + 0.6 * W * np.cos(b)])
            length = max(np.linalg.norm(p1 - p0), 1.0)
            t = np.linspace(0, 1, int(2 * length) + 2)[:, None]
            d = (p1 - p0) / length
            amp, freq = rng.uniform(0.03, 0.1) * H, rng.uniform(1, 3)
            phase = rng.uniform(0, 2 * np.pi)
            pts = p0 + t * (p1 - p0) + np.array([-d[1], d[0]]) * (
                amp * np.sin(2 * np.pi * freq * t + phase))
            r = rng.uniform(1.5, 3.5)
            ri = int(np.ceil(r))
            oy, ox = np.mgrid[-ri:ri + 1, -ri:ri + 1]
            disk = oy ** 2 + ox ** 2 <= r * r
            c = np.round(pts).astype(np.int64)
            yy, xx = (c[:, :1] + oy[disk]).ravel(), (c[:, 1:] + ox[disk]).ravel()
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            seg[yy[inside], xx[inside]] = label
    return seg


def retina_cases(seed: int, n: int, shape, device) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seg = vessel_map(rng, shape)
        img = 100 + 40 * (seg == 1) - 40 * (seg == 2) + rng.normal(0, 15, seg.shape)
        data = ((img - 100) / 40).astype(np.float32)
        out.append((torch.from_numpy(data).to(device), torch.from_numpy(seg).to(device)))
    return out


def make_cases(traffic: dict, config: dict, seed: int, device) -> list:
    """The traffic's cases: ``[(data (*shape), seg (*shape))]`` on ``device``."""
    if traffic["generator"] == "ct":
        return ct_cases(seed, traffic["cases"], traffic["shape"], config["num_classes"], device)
    if traffic["generator"] == "retina":
        return retina_cases(seed, traffic["cases"], traffic["shape"], device)
    raise ValueError(f"unknown generator {traffic['generator']!r}")


def write_dataset(folder: str, cases: list, config: dict, seed: int) -> list[str]:
    """Plans, ``dataset.json``, the cases and ``splits_final.json`` (fold 0:
    every case but the last trains); returns the training case ids."""
    os.makedirs(folder, exist_ok=True)
    plans = {"dataset_name": "Dataset999_Bench", "plans_name": "nnUNetPlans",
             "configurations": {config["configuration"]: config["plans"]}}
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(config["dataset_json"], f)
    gen = torch.Generator(device=cases[0][1].device).manual_seed(seed + 1)
    ids = []
    for i, (data, seg) in enumerate(cases):
        cid = f"case_{i:03d}"
        fg = {}
        for c in range(1, config["num_classes"]):
            locs = torch.nonzero(seg == c)
            if len(locs) > FG_LOCATIONS:
                pick = torch.randperm(len(locs), generator=gen, device=locs.device)[:FG_LOCATIONS]
                locs = locs[pick.sort().values]
            if len(locs):
                fg[f"fg_{c}"] = locs.to(torch.int32).cpu().numpy()
        np.savez(os.path.join(folder, f"{cid}.npz"), data=data[None].cpu().numpy(),
                 seg=seg.cpu().numpy(), **fg)
        ids.append(cid)
    with open(os.path.join(folder, "splits_final.json"), "w") as f:
        json.dump([{"train": ids[:-1], "val": ids[-1:]}], f)
    return ids[:-1]


def read_cases(folder: str, ids: list[str]) -> list:
    """``[(data, seg, {class: locations})]`` as written, classes in file order."""
    out = []
    for cid in ids:
        with np.load(os.path.join(folder, f"{cid}.npz")) as z:
            out.append((z["data"], z["seg"],
                        {int(k[3:]): z[k] for k in z.files if k.startswith("fg_")}))
    return out
