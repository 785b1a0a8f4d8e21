"""The masked multi-task loss suite (counterpart of auformer/losses)."""
from .losses import (AU_POS_WEIGHT, DICE_POS_WEIGHT, EX_CLASS_WEIGHT,
                     SUITES, LossSuite, au_bce_loss, bce_with_logits,
                     ccc_loss, ccc_smooth_l1_loss, dice_au_loss, ex_ce_loss,
                     ex_focal_loss, ex_focal_topk_loss, focal_au_loss,
                     label_smoothing_ce_loss, sce_and_focal_loss,
                     smooth_au_loss)

__all__ = [
    "au_bce_loss", "dice_au_loss", "smooth_au_loss", "focal_au_loss",
    "ccc_loss", "ccc_smooth_l1_loss", "ex_ce_loss", "ex_focal_loss",
    "ex_focal_topk_loss", "label_smoothing_ce_loss", "sce_and_focal_loss",
    "bce_with_logits", "AU_POS_WEIGHT", "DICE_POS_WEIGHT", "EX_CLASS_WEIGHT",
    "LossSuite", "SUITES",
]
