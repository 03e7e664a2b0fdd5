"""The seven public trainers under the reference's names, and the vanilla
``nnUNetTrainer``: counterpart of ``nextou_tpu/train/trainers.py``.

Each subclass only overrides the loss configuration and/or mirroring, as the
reference does:

- ``nnUNetTrainer_NexToU``               base DC+CE (``nnUNetTrainer_NexToU.py``)
- ``nnUNetTrainer_NexToU_NoMirroring``   no mirror DA, no TTA mirroring
- ``nnUNetTrainer_NexToU_TI``            + TI loss, exclusion = all fg pairs
- ``nnUNetTrainer_NexToU_TI_NoMirroring``
- ``nnUNetTrainer_NexToU_BTI_Synapse``   + BTI, BTCV 13-organ binary tree
- ``nnUNetTrainer_NexToU_BTI_RAVIR``     + BTI, RAVIR [[1, 2]]
- ``nnUNetTrainer_NexToU_BTI_ICA_NoMirroring``  + BTI, 18-artery tree, no mirror

λ_ti = 1e-6 (3D) / 1e-4 (2D), connectivity 26 / 8, min_thick 1
(``nnUNetTrainer_NexToU_TI.py:40-45``).
"""

from __future__ import annotations

from itertools import combinations

from nextou_tpu_torch.losses import CompoundLossSpec, TILossSpec
from nextou_tpu_torch.train.registry import register_trainer
from nextou_tpu_torch.train.trainer import NexToUTrainer


# registry alias with the reference's exact public name
@register_trainer
class nnUNetTrainer_NexToU(NexToUTrainer):
    pass


@register_trainer
class nnUNetTrainer(NexToUTrainer):
    """Vanilla nnU-Net trainer: builds the architecture the plans name
    (PlainConvUNet or ResidualEncoderUNet) instead of forcing NexToU. It
    registers under its name, but building its network raises until the
    plain and residual U-Nets are ported (ROADMAP M6b)."""

    def build_network_spec(self):
        raise NotImplementedError(
            f"nnUNetTrainer builds the plans' {self.configuration_manager.UNet_class_name}: the "
            "plain and residual U-Nets are not ported yet (ROADMAP M6b)")


class _NoMirroringMixin:
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # disables TTA mirroring too (nnUNetTrainer_NexToU_NoMirroring.py:8-9)
        self.inference_allowed_mirroring_axes = None

    def configure_mirroring(self):
        return ()


@register_trainer
class nnUNetTrainer_NexToU_NoMirroring(_NoMirroringMixin, NexToUTrainer):
    pass


class _TISettings:
    """Shared λ/connectivity selection (nnUNetTrainer_NexToU_TI.py:36-45)."""

    def _ti_params(self):
        dim = self.configuration_manager.spatial_dims
        if dim == 3:
            return dim, 26, 1e-6
        return dim, 8, 1e-4

    def _make_loss_spec(self, inclusion, exclusion) -> CompoundLossSpec:
        dim, connectivity, lambda_ti = self._ti_params()
        ti = TILossSpec.create(
            dim=dim,
            connectivity=connectivity,
            inclusion=inclusion,
            exclusion=exclusion,
            min_thick=1,
        )
        return CompoundLossSpec(
            weight_ce=1.0,
            weight_dice=1.0,
            weight_ti=lambda_ti,
            batch_dice=self.configuration_manager.batch_dice,
            smooth=1e-5,
            do_bg=False,
            ignore_label=self.label_manager.ignore_label,
            ti=ti,
        )


@register_trainer
class nnUNetTrainer_NexToU_TI(_TISettings, NexToUTrainer):
    """TI loss; exclusion = all pairwise combinations of foreground labels
    (nnUNetTrainer_NexToU_TI.py:10-13,48)."""

    def _loss_spec(self):
        n_fg = max(self.label_manager.all_labels)
        exclusion = [list(c) for c in combinations(range(1, n_fg + 1), 2)]
        return self._make_loss_spec([], exclusion)


@register_trainer
class nnUNetTrainer_NexToU_TI_NoMirroring(
    _NoMirroringMixin, nnUNetTrainer_NexToU_TI
):
    pass


@register_trainer
class nnUNetTrainer_NexToU_BTI_Synapse(_TISettings, NexToUTrainer):
    """BTCV/Synapse 13-organ binary interaction tree
    (nnUNetTrainer_NexToU_BTI_Synapse.py:43-44)."""

    EXCLUSION = [
        [[1, 3, 5, 7, 8, 11, 13], [2, 4, 6, 9, 10, 12]],
        [[1, 3, 11, 13], [5, 7, 8]],
        [[1, 3], [11, 13]],
        [1, 3],
        [11, 13],
        [[5, 8], [7]],
        [5, 8],
        [[4, 6, 10], [2, 9, 12]],
        [[4, 6], [10]],
        [4, 6],
        [[9, 12], [2]],
        [9, 12],
    ]

    def _loss_spec(self):
        return self._make_loss_spec([], self.EXCLUSION)


@register_trainer
class nnUNetTrainer_NexToU_BTI_RAVIR(_TISettings, NexToUTrainer):
    """RAVIR retinal artery/vein exclusion (nnUNetTrainer_NexToU_BTI_RAVIR.py:43)."""

    EXCLUSION = [[1, 2]]

    def _loss_spec(self):
        return self._make_loss_spec([], self.EXCLUSION)


@register_trainer
class nnUNetTrainer_NexToU_BTI_ICA_NoMirroring(
    _NoMirroringMixin, _TISettings, NexToUTrainer
):
    """18-class intracranial artery tree, no mirroring
    (nnUNetTrainer_NexToU_BTI_ICA_NoMirroring.py:43)."""

    EXCLUSION = [
        [[7, 9, 11, 12, 14, 15, 16, 17, 18], [1, 2, 3, 4, 5, 6, 8, 10, 13]],
        [[7, 9, 11, 12], [14, 15, 16, 17, 18]],
        [[7, 9], [11, 12]],
        [7, 9],
        [11, 12],
        [[14, 15], [16, 17, 18]],
        [14, 15],
        [[16, 17], [18]],
        [16, 17],
        [[3, 8, 10, 13], [1, 2, 4, 5, 6]],
        [[3, 10], [8, 13]],
        [3, 10],
        [8, 13],
        [[1, 6], [2, 4, 5]],
        [1, 6],
        [[2, 4], [5]],
        [2, 4],
    ]

    def _loss_spec(self):
        return self._make_loss_spec([], self.EXCLUSION)
