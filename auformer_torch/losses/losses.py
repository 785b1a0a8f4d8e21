"""Masked multi-task loss suite (counterpart of auformer/losses/losses.py;
reference models/loss.py).

Fixed-shape masking as in the JAX package: sentinel rows are weighted out
and denominators count valid rows, which equals the reference's
gather-then-reduce for every reduction used. Every function takes
tensors and returns a 0-d f32 tensor.

The reference's quirks are kept on purpose:
  * AU row masking: a sample is valid iff its FIRST AU label != -1
    (loss.py:86-88,171-174); per-column partial masking is NOT applied.
  * CCCLoss divides by the PRE-mask batch size and uses the unbiased
    (n-1) variance, returning 0 when <= 1 label is valid (loss.py:292-309).
  * FocalLoss_Ori 'mean' divides by N and then again by the valid count
    (loss.py:460-463).
  * EX labels arrive remapped -1 -> 7 and every EX loss ignores class 7
    (train.py:126,208).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

# reference loss.py:73 / :154
AU_POS_WEIGHT = np.array([1, 1, 1, 1, 1, 1, 1, 3, 3, 3, 1, 2], np.float32)
DICE_POS_WEIGHT = np.array([1, 2, 1, 1, 1, 1, 1, 6, 6, 5, 1, 5], np.float32)
# reference audio.py:53 intent (8th weight-0 entry dropped, SURVEY §2.4)
EX_CLASS_WEIGHT = np.array([2.62, 26.5, 45, 40, 4.0, 5.87, 1.0], np.float32)

AU_IGNORE = -1.0
EX_IGNORE = 7
VA_IGNORE = -5.0


@functools.lru_cache(maxsize=64)
def _device_f32(data: bytes, shape: tuple, device: torch.device
                ) -> torch.Tensor:
    return torch.from_numpy(
        np.frombuffer(data, np.float32).reshape(shape).copy()).to(device)


def _const(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as f32 on ``like``'s device, made once per (values,
    device): a step makes no host-to-device copy, so it can be captured in
    a CUDA graph. Read-only."""
    v = np.asarray(value, np.float32)
    return _device_f32(v.tobytes(), v.shape, like.device)


def _safe_div(num: torch.Tensor, den) -> torch.Tensor:
    """num / den where den > 0, else 0; ``den`` a tensor or a number."""
    if not torch.is_tensor(den):
        den = torch.full((), den, dtype=torch.float32, device=num.device)
    den = den.float()
    return torch.where(den > 0, num / den.clamp(min=1e-12),
                       torch.zeros_like(num))


def bce_with_logits(logits, targets, pos_weight=None) -> torch.Tensor:
    """Elementwise torch BCEWithLogitsLoss(reduction='none') semantics."""
    logits = logits.float()
    targets = targets.float()
    sp = F.softplus(-logits)                 # -log sigmoid(x)
    if pos_weight is None:
        return (1.0 - targets) * logits + sp
    pw = _const(pos_weight, logits)
    return (1.0 - targets) * logits + (1.0 + (pw - 1.0) * targets) * sp


def _au_row_mask(y_true) -> torch.Tensor:
    """Valid iff first AU label != -1 (loss.py:86-88)."""
    return (y_true[:, 0] != AU_IGNORE).float()


def au_bce_loss(y_pred, y_true, pos_weight=AU_POS_WEIGHT) -> torch.Tensor:
    """reference AULoss (loss.py:63-103): masked mean of pos-weighted BCE."""
    m = _au_row_mask(y_true)
    elem = bce_with_logits(y_pred, y_true, pos_weight) * m[:, None]
    return _safe_div(elem.sum(), m.sum() * y_pred.shape[1])


def _masked_dice(y_pred, y_true, row_mask) -> torch.Tensor:
    """Per-column DiceLoss over valid rows (loss.py:124-147), summed over
    columns (MultiLabelDiceLoss, loss.py:105-122; its weights arg is dead)."""
    p = torch.sigmoid(y_pred.float()) * row_mask[:, None]
    t = y_true.float() * row_mask[:, None]
    inter = (p * t).sum(dim=0)
    dice = 1.0 - (2.0 * inter + 1.0) / (p.sum(dim=0) + t.sum(dim=0) + 1.0)
    return dice.sum()


def dice_au_loss(y_pred, y_true, pos_weight=DICE_POS_WEIGHT) -> torch.Tensor:
    """reference DiceAULoss (loss.py:149-176): dice-sum + 5 x weighted BCE."""
    m = _au_row_mask(y_true)
    dice = _masked_dice(y_pred, y_true, m)
    elem = bce_with_logits(y_pred, y_true, pos_weight) * m[:, None]
    bce = _safe_div(elem.sum(), m.sum() * y_pred.shape[1])
    return dice + 5.0 * bce


def smooth_au_loss(y_pred, y_true, pos_weight=AU_POS_WEIGHT,
                   smoothing=0.1) -> torch.Tensor:
    """reference SmoothAULoss intent (loss.py:178-220): pos-weighted BCE +
    label-smoothed BCE whose ``weight`` lands on the elementwise weight
    (SmoothingBCELossWithLogits, loss.py:12-31)."""
    m = _au_row_mask(y_true)
    n = m.sum() * y_pred.shape[1]
    plain = bce_with_logits(y_pred, y_true, pos_weight) * m[:, None]
    sm_t = y_true.float() * (1 - smoothing) + 0.5 * smoothing
    smooth = (bce_with_logits(y_pred, sm_t) * _const(pos_weight, m)
              * m[:, None])
    return _safe_div(plain.sum(), n) + _safe_div(smooth.sum(), n)


def focal_au_loss(y_pred, y_true, pos_weight=AU_POS_WEIGHT,
                  gamma=2.0, balance=0.25) -> torch.Tensor:
    """reference FocalAULoss intent (loss.py:222-264): masked weighted-BCE
    mean + FocalLoss2d (loss.py:34-61) as a scalar transform of that mean:
    logpt = -mean_bce, focal = -(1-e^logpt)^gamma * logpt * balance."""
    m = _au_row_mask(y_true)
    n = m.sum() * y_pred.shape[1]
    elem = bce_with_logits(y_pred, y_true, pos_weight) * m[:, None]
    mean_bce = _safe_div(elem.sum(), n)
    logpt = -mean_bce
    pt = torch.exp(logpt)
    focal = -((1.0 - pt) ** gamma) * logpt * balance
    return mean_bce + focal


def ccc_loss(y_pred, y_true, ignore=VA_IGNORE) -> torch.Tensor:
    """reference CCCLoss (loss.py:271-313) for one dimension: y_pred,
    y_true (N,). Unbiased variances, the denominator scaled by the PRE-mask
    batch size, 0 when <= 1 label is valid."""
    y_pred = y_pred.float()
    y_true = y_true.float()
    batch_size = y_pred.shape[0]
    m = (y_true != ignore).float()
    cnt = m.sum()
    mean_p = _safe_div((y_pred * m).sum(), cnt)
    mean_t = _safe_div((y_true * m).sum(), cnt)
    dof = (cnt - 1).clamp(min=1)
    var_p = _safe_div((m * (y_pred - mean_p) ** 2).sum(), dof)
    var_t = _safe_div((m * (y_true - mean_t) ** 2).sum(), dof)
    s_xy = (m * (y_pred - mean_p) * (y_true - mean_t)).sum()
    denom = var_p + var_t + (mean_p - mean_t) ** 2 + 1e-8
    ccc = 2.0 * s_xy / (denom * batch_size)
    return torch.where(cnt > 1, 1.0 - ccc, torch.zeros_like(ccc))


def ccc_smooth_l1_loss(y_pred, y_true, ignore=VA_IGNORE) -> torch.Tensor:
    """reference CCC_SmoothL1 intent (loss.py:315-318): SmoothL1 (beta=1)
    on valid labels + the CCC loss."""
    m = (y_true != ignore).float()
    d = (y_pred - y_true).abs()
    sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5) * m
    return _safe_div(sl1.sum(), m.sum()) + ccc_loss(y_pred, y_true, ignore)


def _ex_targets(y_true, ignore_index):
    """(flat int64 targets with the ignored class clamped to 0, valid
    mask as f32)."""
    y_true = y_true.reshape(-1).long()
    valid = (y_true != ignore_index).float()
    return torch.where(y_true == ignore_index, torch.zeros_like(y_true),
                       y_true), valid


def ex_ce_loss(y_pred, y_true, ignore_index=EX_IGNORE,
               class_weight=None) -> torch.Tensor:
    """torch CrossEntropyLoss(ignore_index=7[, weight]) semantics:
    sum(w[y] * nll) / sum(w[y]) over valid rows."""
    tgt, valid = _ex_targets(y_true, ignore_index)
    logp = F.log_softmax(y_pred.float(), dim=-1)
    nll = -logp.gather(1, tgt[:, None])[:, 0]
    w = valid if class_weight is None else \
        _const(class_weight, logp)[tgt] * valid
    return _safe_div((nll * w).sum(), w.sum())


def ex_focal_loss(y_pred, y_true, num_class=7, gamma=2.0,
                  ignore_index=EX_IGNORE, smooth=1e-4) -> torch.Tensor:
    """reference FocalLoss_Ori (loss.py:388-466) with reduction='mean',
    including the double division (mean over N, then / valid count)."""
    tgt, valid = _ex_targets(y_true, ignore_index)
    n = tgt.shape[0]
    p = torch.softmax(y_pred.float(), dim=1)
    pt = p.gather(1, tgt[:, None])[:, 0] + smooth
    loss = -((1.0 - pt) ** gamma) * torch.log(pt) * valid
    return _safe_div(loss.sum() / n, valid.sum())


def ex_focal_topk_loss(y_pred, y_true, gamma=2.0, alpha=0.25,
                       top_frac=0.2) -> torch.Tensor:
    """reference FocalLoss_TOPK (loss.py:339-386): top-20% hard mining over
    per-sample focal CE (no ignore handling in the reference)."""
    y_true = y_true.reshape(-1).long()
    n = y_true.shape[0]
    p = torch.softmax(y_pred.float(), dim=1)
    pt = p.gather(1, y_true[:, None])[:, 0]
    loss = -alpha * ((1.0 - pt) ** gamma) * torch.log(pt)
    k = max(int(n * top_frac), 1)
    return torch.topk(loss, k).values.mean()


def label_smoothing_ce_loss(y_pred, y_true, epsilon=0.1,
                            ignore_index=EX_IGNORE) -> torch.Tensor:
    """reference LabelSmoothingCrossEntropy (loss.py:326-337), with the
    ignored class clamped and its rows zeroed as the JAX package does (the
    reference would index out of bounds)."""
    tgt, valid = _ex_targets(y_true, ignore_index)
    logp = F.log_softmax(y_pred.float(), dim=-1)
    nclass = y_pred.shape[-1]
    nll = -logp.gather(1, tgt[:, None])[:, 0] * valid
    smooth_term = -logp.sum(dim=-1) * valid
    return (epsilon * _safe_div(smooth_term.sum(), valid.sum()) / nclass
            + (1 - epsilon * 2) * _safe_div(nll.sum(), valid.sum()))


def sce_and_focal_loss(y_pred, y_true) -> torch.Tensor:
    """reference sCE_and_focal_loss (loss.py:266-269)."""
    return (label_smoothing_ce_loss(y_pred, y_true)
            + ex_focal_loss(y_pred, y_true))


@dataclasses.dataclass(frozen=True)
class LossSuite:
    """The task losses a model exposes as get_{ex,au,va,mt}_loss.

    va_weight_v: the V-branch multiplier (most models 2*ccc(v) + ccc(a),
    avformer.py:119-123; sformer 1:1, sformer.py:415-421).
    """
    ex: Callable = ex_ce_loss
    au: Callable = au_bce_loss
    va_each: Callable = ccc_loss
    va_weight_v: float = 2.0

    def get_ex_loss(self, y_pred, y_true):
        return self.ex(y_pred[:, 12:19], y_true)

    def get_au_loss(self, y_pred, y_true):
        return self.au(y_pred[:, :12], y_true)

    def get_va_loss(self, y_pred, y_true):
        v = torch.tanh(y_pred[:, 19])
        a = torch.tanh(y_pred[:, 20])
        return (self.va_weight_v * self.va_each(v, y_true[:, 0])
                + self.va_each(a, y_true[:, 1]))

    def get_mt_loss(self, y_pred, y_true: dict, normalize: bool = False):
        """[ex, au, va] like the reference get_mt_loss (audio.py:88-114);
        normalize divides each by its valid-label count."""
        lex = self.get_ex_loss(y_pred, y_true["EX"])
        lau = self.get_au_loss(y_pred, y_true["AU"])
        lva = self.get_va_loss(y_pred, y_true["VA"])
        if normalize:
            counts = ((y_true["EX"].reshape(-1) != EX_IGNORE).sum(),
                      (y_true["AU"] != AU_IGNORE).sum(),
                      (y_true["VA"] != VA_IGNORE).sum())
            lex, lau, lva = (torch.where(c > 0, loss / c.clamp(min=1),
                                         torch.zeros_like(loss))
                             for loss, c in zip((lex, lau, lva), counts))
        return [lex, lau, lva]


def _weighted_ce(y_pred, y_true):
    return ex_ce_loss(y_pred, y_true, class_weight=EX_CLASS_WEIGHT)


def _plain_bce(y_pred, y_true):
    return au_bce_loss(y_pred, y_true, np.ones(12, np.float32))


# constructor bindings per model (each model file of the reference)
SUITES: dict[str, LossSuite] = {
    # avformer.py:89-91: FocalLoss_Ori / AULoss / CCC, VA 2:1
    "avformer": LossSuite(ex=ex_focal_loss, au=au_bce_loss),
    # vformer.py:375-379: CE / AULoss / CCC
    "vformer": LossSuite(ex=ex_ce_loss, au=au_bce_loss),
    # sformer.py:359-363: CE / DiceAULoss / CCC, VA 1:1
    "sformer": LossSuite(ex=ex_ce_loss, au=dice_au_loss, va_weight_v=1.0),
    # tformer.py:423-427: CE / AULoss / CCC
    "tformer": LossSuite(ex=ex_ce_loss, au=au_bce_loss),
    # dual_sformer.py:300-304: CE / AULoss / CCC, VA 1:1 (:331-337)
    "dsformer": LossSuite(ex=ex_ce_loss, au=au_bce_loss, va_weight_v=1.0),
    # audio.py:53-56: weighted CE / DiceAULoss / CCC
    "audio": LossSuite(ex=_weighted_ce, au=dice_au_loss),
    # van.py:351-355: CE / AULoss / CCC, VA 1:1 (:404-410)
    "van": LossSuite(ex=ex_ce_loss, au=au_bce_loss, va_weight_v=1.0),
    "vggformer": LossSuite(ex=ex_ce_loss, au=au_bce_loss),
    "i3d": LossSuite(ex=ex_ce_loss, au=au_bce_loss),
    "mc3d": LossSuite(ex=ex_ce_loss, au=au_bce_loss),
    # resnet.py:28-30: CE / plain BCE intent / CCC, VA 1:1 (:76-80)
    "resnet": LossSuite(ex=ex_ce_loss, au=_plain_bce, va_weight_v=1.0),
    # emonet.py:228-230: CE / SmoothAULoss / CCC, VA 1:1 (:281-286)
    "emonet": LossSuite(ex=ex_ce_loss, au=smooth_au_loss, va_weight_v=1.0),
    # tsav.py:81-84: weighted CE intent / AULoss / CCC, VA 1:1 (:109-115)
    "tsav": LossSuite(ex=_weighted_ce, au=au_bce_loss, va_weight_v=1.0),
}
