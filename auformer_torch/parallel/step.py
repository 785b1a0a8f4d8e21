"""Train and eval steps (counterpart of auformer/parallel/step.py; the
reference's loop body, train.py:202-244), on one device.

  * uint8 clips are augmented (``--device_augment``), normalized and
    flipped on the device inside the step; under ``--device_audio`` the
    log-mel features of the loader's left-aligned raw windows are computed
    there too;
  * parameters and BatchNorm statistics stay f32; under
    ``compute_dtype=bfloat16`` the forward runs in ``torch.autocast``
    (bf16 convolutions and matmuls, f32 norms and losses, the AU heads'
    token projection and logits f32 from bf16 operands), the counterpart
    of the JAX modules' ``dtype`` with f32 ``param_dtype`` (ROADMAP.md C
    names the two places where the rounding departs from flax's);
  * the streams the reference freezes (avformer.py:78-85: ``audio_model``
    and ``video_model``) get ``requires_grad=False`` and stay out of the
    optimizer, which equals the JAX package's ``set_to_zero`` partition: only
    the fusion ``au_head`` trains, while every BatchNorm of the model, in
    train mode, still updates its running statistics as in JAX;
  * the step's randomness (augmentation, flip, dropout, in that order) is
    drawn from one ``torch.Generator`` that the caller passes.

Not ported: ``make_multi_train_step`` (``steps_per_dispatch > 1``), the
frame-dedup expander and the wav arena gather; ``train_lib`` raises for
their flags, naming their ROADMAP items.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from ..core.config import Config
from ..losses import LossSuite
from ..nn.blocks import set_dropout_generator
from ..nn.registry import compute_autocast, output_table
from ..ops.audio import HOP_LENGTH, audio_frontend, reflect_end_patch
from ..ops.augment_device import augment_clips_device
from ..ops.preprocess import normalize_clip, random_flip_clips

# subtrees frozen when training avformer with pretrained streams
# (reference avformer.py:78-85: whole audio_model + video_model frozen,
# only the fusion au_head trains)
FROZEN_PREFIXES = {"avformer": ("audio_model", "video_model")}


def trainable_mask(model: torch.nn.Module,
                   frozen_prefixes: tuple[str, ...]) -> dict[str, bool]:
    """Parameter name -> True (train) / False (frozen)."""
    return {name: name.split(".", 1)[0] not in frozen_prefixes
            for name, _ in model.named_parameters()}


def learning_rate(cfg: Config, step: int) -> float:
    """The rate of update ``step`` (0-based): ``cfg.learning_rate``, x0.1
    from epoch 30 and x0.01 from epoch 60 (epoch = step // steps_per_epoch)
    when ``cfg.lr_schedule`` and steps_per_epoch are set, times the linear
    warmup min(1, (step + 1) / n_warmup_steps)."""
    lr = cfg.learning_rate
    if cfg.lr_schedule and cfg.steps_per_epoch:
        epoch = step // max(cfg.steps_per_epoch, 1)
        lr *= 0.01 if epoch >= 60 else 0.1 if epoch >= 30 else 1.0
    if cfg.n_warmup_steps > 0:
        lr *= min(1.0, (step + 1) / cfg.n_warmup_steps)
    return lr


def make_optimizer(cfg: Config, model: torch.nn.Module
                   ) -> torch.optim.Adam:
    """Adam as in the reference (train.py:334: torch Adam, weight_decay as
    L2 into the gradient, eps 1e-8), the same as optax's
    ``add_decayed_weights`` + ``scale_by_adam``, over the trainable
    parameters only. The frozen prefixes of ``cfg.model_name`` get
    ``requires_grad=False``. The rate is set per step by ``TrainState``
    (``learning_rate``); clipping is ``TrainState``'s too."""
    mask = trainable_mask(model, FROZEN_PREFIXES.get(cfg.model_name, ()))
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model (f32 parameters and statistics, on its device), its
    optimizer and the number of updates applied."""
    cfg: Config
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int = 0

    @property
    def params(self) -> list[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def apply_gradients(self) -> None:
        """Clip the trainable gradients to ``cfg.grad_clip`` (global norm,
        when > 0), take one Adam step at this step's rate, clear the
        gradients."""
        if self.cfg.grad_clip and self.cfg.grad_clip > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.cfg.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = learning_rate(self.cfg, self.step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def create_train_state(cfg: Config, model: torch.nn.Module) -> TrainState:
    return TrainState(cfg, model, make_optimizer(cfg, model))


def prep_batch(batch: Mapping[str, torch.Tensor], train: bool,
               generator: torch.Generator | None = None,
               device_augment: bool = False,
               device_audio: bool = False) -> dict:
    """Device-side preprocessing: under ``device_audio`` the log-mel of the
    loader's left-aligned raw windows (``reflect_end_patch`` + the
    left-aligned frontend); then, for a uint8 clip, the AutoAugment
    (train, ``device_augment``, RGB clips), /255 + normalize, and the
    train-time whole-clip flip. Eval never augments."""
    x = dict(batch)
    if device_audio and "audio_features" not in x and "audio" in x \
            and "audio_len" in x:
        raw = x["audio"][:, 0, :].float()
        n_valid = x["audio_len"].reshape(-1).long()
        x["audio_features"] = audio_frontend(
            reflect_end_patch(raw, n_valid),
            feature_len=1 + n_valid // HOP_LENGTH, left_aligned=True)
    clip = x.get("clip")
    if clip is not None and clip.dtype == torch.uint8:
        if train and device_augment and generator is not None \
                and clip.shape[-1] == 3:
            clip = augment_clips_device(clip, generator)
        clip = normalize_clip(clip)
        if train and generator is not None:
            clip = random_flip_clips(clip, generator)
        x["clip"] = clip
    return x


def _labels_of(batch: Mapping[str, torch.Tensor]) -> dict:
    ex = batch["EX"].reshape(-1).long()
    ex = torch.where(ex == -1, 7, ex)  # train.py:126,208 remap
    return {"AU": batch["AU"].float(), "EX": ex, "VA": batch["VA"].float()}


def task_loss(suite: LossSuite, task: str, out, labels):
    t = task.lower()
    if t == "ex":
        return suite.get_ex_loss(out, labels["EX"]), {}
    if t == "au":
        return suite.get_au_loss(out, labels["AU"]), {}
    if t == "va":
        return suite.get_va_loss(out, labels["VA"]), {}
    lex, lau, lva = suite.get_mt_loss(out, labels)
    # multi-task weighting 3*EX + AU + VA (train.py:230)
    return 3.0 * lex + lau + lva, {"ex": lex, "au": lau, "va": lva}


def _forward(cfg: Config, model: torch.nn.Module, x: dict) -> torch.Tensor:
    """The model's f32 output in the (B, 21) layout (``output_table``),
    under bf16 autocast when ``cfg.compute_dtype`` asks for it."""
    device = next(model.parameters()).device
    modes = set(getattr(model, "modes", x.keys()))
    x = {k: v for k, v in x.items() if k in modes}
    with compute_autocast(cfg, device):
        return output_table(model(x).float())


def make_train_step(cfg: Config, model: torch.nn.Module,
                    suite: LossSuite) -> Callable:
    """Returns ``step(state, batch, generator) -> metrics``: ``batch`` holds
    tensors on the model's device, ``generator`` (on that device) draws the
    augmentation, the flip and the dropout masks; ``metrics`` maps "loss"
    (and for task ALL "ex", "au", "va") to 0-d tensors on the device."""
    def step(state: TrainState, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator) -> dict:
        x = prep_batch(batch, train=True, generator=generator,
                       device_augment=cfg.device_augment,
                       device_audio=cfg.device_audio)
        labels = _labels_of(batch)
        model.train()
        set_dropout_generator(model, generator)
        try:
            out = _forward(cfg, model, x)
        finally:
            set_dropout_generator(model, None)
        loss, parts = task_loss(suite, cfg.task, out, labels)
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in parts.items()}}

    return step


def make_eval_step(cfg: Config, model: torch.nn.Module,
                   suite: LossSuite) -> Callable:
    """Returns ``step(batch) -> (out (B, 21) f32, loss)``: the model
    in eval mode (running statistics, no dropout), no augmentation."""
    def step(batch: Mapping[str, torch.Tensor]):
        model.eval()
        with torch.no_grad():
            x = prep_batch(batch, train=False,
                           device_audio=cfg.device_audio)
            out = _forward(cfg, model, x)
            loss, _ = task_loss(suite, cfg.task, out, _labels_of(batch))
        return out, loss

    return step
