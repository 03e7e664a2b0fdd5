"""Train steps on a device held against the same steps on the CPU, and how far
the CPU's own step moves when its state moves by one ulp.

    python -m nextou_tpu_torch.tools.lockstep

:func:`lockstep` is the protocol of ``chip_smoke.py``'s phases 23 (a) and
24 (b). Run as a module, on the CPU alone, it steps the narrow network of the
RAVIR schedule (``synthetic.NARROW_RAVIR_2D``, f32) with the
``nnUNetTrainer_NexToU_BTI_RAVIR`` loss through the data and start of phase
24 (b), ``PROBE_STEPS`` steps at each of ``PROBE_PATCHES`` (the first
NARROW_STEPS are phase 24 (b)'s), and prints per step how far the CPU's
step from its state scaled by each of ``1 + PROBE_EPS`` lies from its step
from the state itself, in each of ``WIDTHS``: where that passes a width, one
ulp of the state moves the step beyond it, and a card that rounds otherwise
may land there too.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

# per step, device against CPU: loss, gradient norm (relative), update (L2
# share of the CPU's), TI term (relative)
WIDTHS = {"loss": 1e-4, "grad_norm": 2e-2, "update": 0.1, "ti": 1e-3}
# a step beyond a width passes only where the device's result lies within the
# widths of the CPU's step from the same state with the parameters scaled by
# one of these (a near tie that a one-ulp change flips the device's way)
WITNESS_EPS = (1e-7, -1e-7, 1e-6, -1e-6)

# phase 24 (b): a NARROW_IMAGE image served, then NARROW_STEPS train steps of
# NARROW_BATCH after NARROW_WARMUP steps of Dice + CE on the CPU, at a learning
# rate of NARROW_LR, from create_train_state's seed NARROW_SEED; the data from
# the same seed
NARROW_IMAGE = (320, 384)
NARROW_STEPS, NARROW_WARMUP, NARROW_BATCH, NARROW_LR, NARROW_SEED = 4, 20, 2, 1e-2, 24
RAVIR_TRAINER = "nnUNetTrainer_NexToU_BTI_RAVIR"
# the module's run: phase 24 (b)'s patch and the one it was cut from
PROBE_PATCHES, PROBE_EPS, PROBE_STEPS = ((128, 128), (256, 256)), (1e-7, -1e-7), 16


def distances(a, b) -> dict:
    """Step result ``a`` against ``b`` (loss, gradient norm, update, TI term),
    each as :data:`WIDTHS` measures it."""
    return {"loss": abs(a[0] - b[0]) / abs(b[0]),
            "grad_norm": abs(a[1] - b[1]) / abs(b[1]),
            "update": ((a[2] - b[2]).norm() / b[2].norm()).item(),
            "ti": 0.0 if b[3] is None else abs(a[3] - b[3]) / abs(b[3])}


def lockstep(dev, spec, batches, legs, loss_specs, opt, seed: int, tag: str, budget: int,
             conv_kernel: str = "0", warmup=(), probe=()) -> tuple[dict, int, list]:
    """Train steps of ``spec`` in f32 on ``dev`` against the same steps on the
    CPU (plain versions), ``dev`` set to the CPU's state after each step: step
    i takes ``batches[i]`` with ``loss_specs[legs[i]]``, deep supervision on.
    Per step: the loss, the gradient norm, the update and, where the loss has
    a TI term, the TI term alone (each model's logits through the
    deep-supervised TI loss, without its lambda) within ``WIDTHS`` of the
    CPU's. Where a step lands on a near tie (a kNN selection, or a max whose
    gradient is discontinuous there), the CPU runs it again from its state
    with the parameters scaled by each of ``WITNESS_EPS``: ``dev``'s result
    must then lie within the same widths of one of those, at no more than
    ``budget`` steps. ``warmup``: (batch, loss spec) pairs the CPU steps
    through first; ``dev`` starts from the state they reach. ``probe``: eps
    at which every step's CPU result from the scaled state is also held
    against the CPU's own. Returns the worst distance of each, the steps
    beyond a width, and per step the probe's distances by eps."""
    from nextou_tpu_torch.losses import deep_supervised_loss, deep_supervision_weights, ti_loss
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.train import create_train_state, make_train_step

    weights = deep_supervision_weights(len(spec.decoder))
    cpu = torch.device("cpu")

    def flat(model):
        return torch.cat([p.detach().cpu().flatten() for p in model.parameters()])

    states, steps, logits = {}, {}, {}
    for kind, d in (("dev", dev), ("cpu", cpu), ("witness", cpu)):
        model = NexToU(spec, conv_kernel=conv_kernel, device=d)
        states[kind] = create_train_state(model, opt, seed=seed)
        model.register_forward_hook(
            lambda m, a, o, kind=kind: logits.__setitem__(kind, [t.detach() for t in o]))
        steps[kind] = [make_train_step(model, opt, s, weights) for s in loss_specs]
    for batch, loss_spec in warmup:
        states["cpu"], _ = make_train_step(states["cpu"].model, opt, loss_spec, weights)(
            states["cpu"], batch)
    if warmup:
        states["dev"].load_state_dict(states["cpu"].state_dict())
    worst = dict.fromkeys(WIDTHS, 0.0)
    witnessed, probed = 0, []

    def run_step(kind, leg, batch, start):
        states[kind], m = steps[kind][leg](states[kind], batch)
        ti, spec_ti = None, loss_specs[leg].ti
        if spec_ti is not None and loss_specs[leg].weight_ti:
            seg = torch.as_tensor(batch["seg"]).long().to(logits[kind][0].device)
            ti = deep_supervised_loss(
                logits[kind], seg, lambda o, t: ti_loss(o, t, spec_ti), weights).item()
        return m["loss"].item(), m["grad_norm"].item(), flat(states[kind].model) - start, ti

    def beyond(off) -> bool:
        return any(off[k] > w for k, w in WIDTHS.items())

    for i, (batch, leg) in enumerate(zip(batches, legs)):
        before = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                  else v.clone() if torch.is_tensor(v) else v
                  for k, v in states["cpu"].state_dict().items()}
        start = flat(states["cpu"].model)
        assert torch.equal(start, flat(states["dev"].model))
        got = {kind: run_step(kind, leg, batch, start) for kind in ("dev", "cpu")}
        scaled = {}

        def cpu_at(eps):
            # the CPU's step from its state with the parameters scaled by 1 + eps
            if eps not in scaled:
                states["witness"].load_state_dict(before)
                with torch.no_grad():
                    for p in states["witness"].model.parameters():
                        p.mul_(1 + eps)
                scaled[eps] = run_step("witness", leg, batch, start * (1 + eps))
            return scaled[eps]

        probed.append({eps: distances(cpu_at(eps), got["cpu"]) for eps in probe})
        off = distances(got["dev"], got["cpu"])
        note = ""
        if beyond(off):
            witnessed += 1
            seen = [(eps, distances(got["dev"], cpu_at(eps)), distances(cpu_at(eps), got["cpu"]))
                    for eps in WITNESS_EPS]
            eps, match, moved = min(seen, key=lambda e: max(e[1][k] / w for k, w in WIDTHS.items()))
            note = (f" (beyond a width: the CPU at 1 {eps:+.0e} moves by " + ", ".join(
                f"{k} {moved[k]:.2e}" for k in WIDTHS) + "; the device from it "
                + ", ".join(f"{k} {match[k]:.2e}" for k in WIDTHS) + ")")
            if beyond(match):
                raise AssertionError(
                    f"{tag} step {i}: off by {off}, and beyond the widths of each one-ulp "
                    f"CPU step: {seen}")
            if witnessed > budget:
                raise AssertionError(f"{tag}: more than {budget} steps beyond a width")
        (gl, gn, _, gt), (wl, wn, _, wt) = got["dev"], got["cpu"]
        print(f"{tag} step {i} ({'TI' if gt is not None else 'no TI'}): loss "
              f"{gl:.6f} vs {wl:.6f}, grad_norm {gn:.4f} vs {wn:.4f}, update off "
              f"{off['update']:.2e}" + (f", TI term {gt:.4f} vs {wt:.4f}" if gt is not None else "")
              + note)
        for eps, moved in probed[-1].items():
            print(f"{tag} step {i}: the CPU at 1 {eps:+.0e} moves by "
                  + ", ".join(f"{k} {moved[k]:.2e}" for k in WIDTHS)
                  + (" (beyond a width)" if beyond(moved) else ""))
        worst = {k: max(worst[k], off[k]) for k in worst}
        states["dev"].load_state_dict(states["cpu"].state_dict())
    return worst, witnessed, probed


def ravir_loss_spec(dev="cpu"):
    """The ``nnUNetTrainer_NexToU_BTI_RAVIR`` loss spec, from the trainer on
    plans whose 2d configuration is ``ravir_2d_spec``'s."""
    from nextou_tpu_torch.models.presets import ravir_2d_spec
    from nextou_tpu_torch.tools.synthetic import RAVIR_DATASET_JSON, plans_for
    from nextou_tpu_torch.train import get_trainer_class

    trainer = get_trainer_class(RAVIR_TRAINER)(
        plans_for(ravir_2d_spec(), "2d", 12), "2d", 0, RAVIR_DATASET_JSON, device=dev)
    return trainer._loss_spec()


def narrow_ravir_run(patch, loss, steps: int = NARROW_STEPS):
    """Phase 24 (b)'s data, from one seeded generator in its order: the
    served image (``NARROW_IMAGE``: normalized f32 (H, W, 1) and its labels),
    then at ``patch`` NARROW_STEPS batches with ``loss``, and the
    NARROW_WARMUP (batch, Dice + CE) pairs that precede them; ``steps`` past
    NARROW_STEPS adds batches drawn after the warm-up. Returns the image, its
    labels, the narrow RAVIR network's deep-supervised spec at ``patch``, the
    batches and the warm-up."""
    from nextou_tpu_torch.models.spec import build_model_spec
    from nextou_tpu_torch.tools.synthetic import (
        NARROW_RAVIR_2D, retina_image, vessel_batch, vessel_map,
    )

    spec = build_model_spec(**{**NARROW_RAVIR_2D, "patch_size": tuple(patch)},
                            deep_supervision=True)
    rng = np.random.default_rng(NARROW_SEED)
    seg = vessel_map(rng, NARROW_IMAGE)
    image = ((retina_image(rng, seg) - 100) / 40)[..., None]
    batches = [vessel_batch(rng, NARROW_BATCH, spec.patch_size)
               for _ in range(min(steps, NARROW_STEPS))]
    dice_ce = dataclasses.replace(loss, weight_ti=0.0, ti=None)
    warmup = [(vessel_batch(rng, NARROW_BATCH, spec.patch_size), dice_ce)
              for _ in range(NARROW_WARMUP)]
    batches += [vessel_batch(rng, NARROW_BATCH, spec.patch_size)
                for _ in range(steps - NARROW_STEPS)]
    return image, seg, spec, batches, warmup


def main() -> int:
    from nextou_tpu_torch.train import make_optimizer

    cpu = torch.device("cpu")
    loss = ravir_loss_spec()
    print(f"CPU: torch {torch.__version__}, {torch.get_num_threads()} threads; widths {WIDTHS}")
    for patch in PROBE_PATCHES:
        tag = "x".join(map(str, patch))
        _, _, spec, batches, warmup = narrow_ravir_run(patch, loss, PROBE_STEPS)
        _, _, probed = lockstep(cpu, spec, batches, [0] * len(batches), [loss],
                                make_optimizer(NARROW_LR), NARROW_SEED, tag, len(batches),
                                warmup=warmup, probe=PROBE_EPS)
        over = [i for i, step in enumerate(probed)
                if any(d[k] > w for d in step.values() for k, w in WIDTHS.items())]
        print(f"{tag}: {len(over)} of {len(probed)} steps move beyond a width at one of "
              f"1 + {PROBE_EPS}: steps {over}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
