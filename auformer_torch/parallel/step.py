"""Train and eval steps (counterpart of auformer/parallel/step.py; the
reference's loop body, train.py:202-244), on one device.

  * uint8 clips are augmented (``--device_augment``), normalized and
    flipped on the device inside the step; a frame-dedup batch's clips are
    gathered from its pool of unique frames first; under
    ``--device_audio`` the log-mel features of the left-aligned raw windows
    (the loader's, or gathered from the wav arena) are computed there too;
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

Not ported: ``make_multi_train_step`` (``steps_per_dispatch > 1``);
``train_lib`` raises for its flag, naming ROADMAP.md A13.
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


def gather_arena_windows(arena: torch.Tensor, ofs: torch.Tensor,
                         n_valid: torch.Tensor, sample_len: int
                         ) -> torch.Tensor:
    """(B,) arena offsets and valid counts -> (B, sample_len) float32
    left-aligned windows, bitwise equal to the host-built buffers of
    ``Aff2CompDataset.get_audio_window`` (zeros past n_valid, so a slice
    that runs into the next video in the packed arena is zeroed back).
    Rows of the strided view ``arena.unfold(0, sample_len, 1)``: only the
    output is written. The dataset makes every offset within
    ``[0, len(arena) - sample_len]`` (``WavArena.window``); an index past
    the view raises, where JAX's ``dynamic_slice`` would clamp."""
    windows = arena.unfold(0, sample_len, 1)
    raw = windows.index_select(0, ofs.reshape(-1).long())
    past = (torch.arange(sample_len, device=raw.device)[None, :]
            >= n_valid.reshape(-1, 1).long())
    return raw.masked_fill_(past, 0.0)


def expand_dedup_batch(batch: Mapping[str, torch.Tensor]) -> dict:
    """A frame-dedup batch's (U_pad, H, W, C) pool ``frames`` and (B, T)
    window map ``clip_idx`` -> (B, T, H, W, C) ``clip``: one gather,
    bitwise equal to the dense clips ``get_clip`` assembles on the host
    (data/dataset.py::assemble_batch). The other entries pass untouched,
    and a dense batch passes as it is."""
    out = dict(batch)
    if "frames" in out and "clip_idx" in out:
        frames, clip_idx = out.pop("frames"), out.pop("clip_idx")
        out["clip"] = frames.index_select(
            0, clip_idx.reshape(-1).long()).view(*clip_idx.shape,
                                                 *frames.shape[1:])
    return out


def prep_batch(batch: Mapping[str, torch.Tensor], train: bool,
               generator: torch.Generator | None = None,
               device_augment: bool = False,
               device_audio: bool = False,
               arena: torch.Tensor | None = None,
               sample_len: int = 441000) -> dict:
    """Device-side preprocessing: the clips of a frame-dedup batch
    (``expand_dedup_batch``); under ``device_audio`` the log-mel of the
    left-aligned raw windows, shipped by the loader or, with ``arena``,
    gathered from it by the batch's ``audio_ofs`` (``reflect_end_patch``
    + the left-aligned frontend); then, for a uint8 clip, the AutoAugment
    (train, ``device_augment``, RGB clips), /255 + normalize, and the
    train-time whole-clip flip. Eval never augments."""
    x = expand_dedup_batch(batch)
    if device_audio and "audio_features" not in x and "audio_len" in x:
        n_valid = x["audio_len"].reshape(-1).long()
        if arena is not None and "audio_ofs" in x:
            raw = gather_arena_windows(arena, x["audio_ofs"], n_valid,
                                       sample_len)
        elif "audio" in x:
            raw = x["audio"][:, 0, :].float()
        else:
            raw = None
        if raw is not None:
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
    """Returns ``step(state, batch, generator, arena=None) -> metrics``:
    ``batch`` holds tensors on the model's device, ``generator`` (on that
    device) draws the augmentation, the flip and the dropout masks,
    ``arena`` is the wav arena on that device when the batch carries
    arena offsets; ``metrics`` maps "loss" (and for task ALL "ex", "au",
    "va") to 0-d tensors on the device."""
    def step(state: TrainState, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator,
             arena: torch.Tensor | None = None) -> dict:
        x = prep_batch(batch, train=True, generator=generator,
                       device_augment=cfg.device_augment,
                       device_audio=cfg.device_audio, arena=arena,
                       sample_len=cfg.sample_len_frames)
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
    """Returns ``step(batch, arena=None) -> (out (B, 21) f32, loss)``: the
    model in eval mode (running statistics, no dropout), no augmentation;
    ``arena`` as the train step's."""
    def step(batch: Mapping[str, torch.Tensor],
             arena: torch.Tensor | None = None):
        model.eval()
        with torch.no_grad():
            x = prep_batch(batch, train=False,
                           device_audio=cfg.device_audio, arena=arena,
                           sample_len=cfg.sample_len_frames)
            out = _forward(cfg, model, x)
            loss, _ = task_loss(suite, cfg.task, out, _labels_of(batch))
        return out, loss

    return step
