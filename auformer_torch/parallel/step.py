"""Train and eval steps (counterpart of auformer/parallel/step.py; the
reference's loop body, train.py:202-244), on one device or, under a mesh,
data parallel over a process group.

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
    drawn from one ``torch.Generator`` that the caller passes;
  * ``make_multi_train_step`` runs K steps per dispatch
    (``--steps_per_dispatch K``): K eager steps on the CPU; on the card a
    CUDA graph of one step, captured once and replayed K times per
    dispatch, the counterpart of the JAX package's ``lax.scan``;
  * under a ``mesh`` (core/mesh.py) each rank holds its rows of the
    global batch and the step is the world-1 step on that batch, as the
    JAX package's GSPMD step is: the random draws are the global batch's
    (``draw_rows``), train-mode BatchNorm reduces its statistics over the
    ranks (nn/blocks.py), the (B, 21) outputs and the labels are gathered
    so that every rank computes the global loss, with only its own rows
    carrying their autograd history (``global_rows``: the remote rows are
    detached, so no rank's backward adds another's), and the trainable
    gradients are SUM-all-reduced before the optimizer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..core.config import Config
from ..core.mesh import Mesh
from ..losses import LossSuite
from ..nn.blocks import set_dropout_generator, set_step_mesh
from ..nn.registry import compute_autocast, output_table
from ..ops.attention import fused_attention
from ..ops.audio import HOP_LENGTH, audio_frontend, reflect_end_patch
from ..ops.audio_kernel import mel_frontend
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


def make_optimizer(cfg: Config, model: torch.nn.Module,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam as in the reference (train.py:334: torch Adam, weight_decay as
    L2 into the gradient, eps 1e-8), the same as optax's
    ``add_decayed_weights`` + ``scale_by_adam``, over the trainable
    parameters only. The frozen prefixes of ``cfg.model_name`` get
    ``requires_grad=False``. The rate is set per step by ``TrainState``
    (``learning_rate``); clipping is ``TrainState``'s too.

    ``capturable``: the Adam of a CUDA graph (``make_multi_train_step`` on
    the card): its step counts live on the parameters' device and its rate
    is a 0-d f32 tensor there, filled per step, so that an update can be
    captured and replayed. PyTorch refuses it for CPU parameters."""
    mask = trainable_mask(model, FROZEN_PREFIXES.get(cfg.model_name, ()))
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    lr = cfg.learning_rate
    if capturable:
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay,
                            capturable=capturable)


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

    def set_rate(self) -> None:
        """This step's rate (``learning_rate``) into every group: a float,
        or the capturable optimizer's rate tensor filled in place."""
        lr = learning_rate(self.cfg, self.step)
        for group in self.optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def update(self) -> None:
        """Clip the trainable gradients to ``cfg.grad_clip`` (global norm,
        when > 0), take one Adam step at the rate set, clear the gradients:
        the part of a step that a CUDA graph captures."""
        if self.cfg.grad_clip and self.cfg.grad_clip > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.cfg.grad_clip)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        """One update at this step's rate; counts the step."""
        self.set_rate()
        self.update()
        self.step += 1


def create_train_state(cfg: Config, model: torch.nn.Module,
                       capturable: bool = False) -> TrainState:
    """``capturable``: the optimizer a CUDA graph of the step needs
    (``make_optimizer``); ``make_multi_train_step`` takes it on the card,
    its eager steps too."""
    return TrainState(cfg, model, make_optimizer(cfg, model, capturable))


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
               sample_len: int = 441000, mesh: Mesh | None = None) -> dict:
    """Device-side preprocessing: the clips of a frame-dedup batch
    (``expand_dedup_batch``); under ``device_audio`` the log-mel of the
    left-aligned raw windows, shipped by the loader or, with ``arena``,
    gathered from it by the batch's ``audio_ofs`` (``reflect_end_patch``
    + the left-aligned frontend); then, for a uint8 clip, the AutoAugment
    (train, ``device_augment``, RGB clips), /255 + normalize, and the
    train-time whole-clip flip, their draws those of the global batch
    under a ``mesh``. Eval never augments."""
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
            clip = augment_clips_device(clip, generator, mesh)
        clip = normalize_clip(clip)
        if train and generator is not None:
            clip = random_flip_clips(clip, generator, mesh=mesh)
        x["clip"] = clip
    return x


def _labels_of(batch: Mapping[str, torch.Tensor]) -> dict:
    ex = batch["EX"].reshape(-1).long()
    ex = torch.where(ex == -1, 7, ex)  # train.py:126,208 remap
    return {"AU": batch["AU"].float(), "EX": ex, "VA": batch["VA"].float()}


def global_rows(mesh: Mesh, out: torch.Tensor, labels: dict
                ) -> tuple[torch.Tensor, dict]:
    """The (B_global, 21) outputs and the labels of the global batch from
    every rank's (B, 21) ``out`` and ``labels`` (one all-gather of both):
    this rank's rows of the outputs are ``out`` itself, with its autograd
    history, and the other ranks' are detached. The global loss is the
    same number on every rank, and each rank's backward carries its
    gradient through its own rows only, so the SUM of the ranks'
    gradients is the world-1 gradient (a gather with autograd would add
    every rank's identical loss gradient: N times too much)."""
    b = out.shape[0]
    packed = torch.cat([out.detach().float(), labels["AU"].float(),
                        labels["EX"].float()[:, None],
                        labels["VA"].float()], 1)
    full = mesh.all_gather_rows(packed)
    rows, width = mesh.rows(b), out.shape[1]
    out = torch.cat([full[:rows.start, :width], out,
                     full[rows.stop:, :width]])
    au = labels["AU"].shape[1]
    return out, {"AU": full[:, width:width + au],
                 "EX": full[:, width + au].long(),
                 "VA": full[:, width + au + 1:]}


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


def _forward(cfg: Config, model: torch.nn.Module, x: dict,
             autocast_cache: bool = True) -> torch.Tensor:
    """The model's f32 output in the (B, 21) layout (``output_table``),
    under bf16 autocast when ``cfg.compute_dtype`` asks for it (its cache
    off for a region a CUDA graph captures)."""
    device = next(model.parameters()).device
    modes = set(getattr(model, "modes", x.keys()))
    x = {k: v for k, v in x.items() if k in modes}
    with compute_autocast(cfg, device, cache_enabled=autocast_cache):
        return output_table(model(x).float())


def _step_body(cfg: Config, model: torch.nn.Module, suite: LossSuite,
               state: TrainState, batch: Mapping[str, torch.Tensor],
               generator: torch.Generator, arena: torch.Tensor | None,
               graphed: bool, mesh: Mesh | None = None) -> dict:
    """One train step: prep, forward, loss, backward, update. ``graphed``:
    the body a CUDA graph captures, where the caller sets the rate before
    each replay and counts the step (no autocast cache, no host value).
    ``mesh``: the data-parallel step (the module docstring)."""
    x = prep_batch(batch, train=True, generator=generator,
                   device_augment=cfg.device_augment,
                   device_audio=cfg.device_audio, arena=arena,
                   sample_len=cfg.sample_len_frames, mesh=mesh)
    labels = _labels_of(batch)
    model.train()
    set_dropout_generator(model, generator)
    set_step_mesh(model, mesh)
    try:
        out = _forward(cfg, model, x, autocast_cache=not graphed)
    finally:
        set_dropout_generator(model, None)
        set_step_mesh(model, None)
    if mesh is not None:
        out, labels = global_rows(mesh, out, labels)
    loss, parts = task_loss(suite, cfg.task, out, labels)
    loss.backward()
    if mesh is not None:
        mesh.all_reduce_grads(state.params)
    if graphed:
        state.update()
    else:
        state.apply_gradients()
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in parts.items()}}


def make_train_step(cfg: Config, model: torch.nn.Module,
                    suite: LossSuite, mesh: Mesh | None = None) -> Callable:
    """Returns ``step(state, batch, generator, arena=None) -> metrics``:
    ``batch`` holds tensors on the model's device, ``generator`` (on that
    device) draws the augmentation, the flip and the dropout masks,
    ``arena`` is the wav arena on that device when the batch carries
    arena offsets; ``metrics`` maps "loss" (and for task ALL "ex", "au",
    "va") to 0-d tensors on the device. Under a ``mesh`` the batch is this
    rank's rows of the global batch, every rank's generator is seeded
    alike, and the metrics are the global batch's."""
    def step(state: TrainState, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator,
             arena: torch.Tensor | None = None) -> dict:
        return _step_body(cfg, model, suite, state, batch, generator, arena,
                          graphed=False, mesh=mesh)

    return step


def stack_batches(batches: Sequence[Mapping]) -> dict:
    """Host collation for ``make_multi_train_step``: K loader batches ->
    one dict of (K, B, ...) numpy arrays, numeric entries only (string
    and object entries such as video ids do not go to the device), as the
    JAX package's ``stack_batches``."""
    keys = [k for k, v in batches[0].items()
            if np.asarray(v).dtype.kind not in ("U", "S", "O")]
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}


def make_device_stacker() -> Callable:
    """Returns ``stack(*batches) -> dict`` of (K, B, ...) tensors: the
    device-side counterpart of ``stack_batches`` (the JAX package's
    ``make_device_stacker``). Each of the K batches, already on the
    device, is copied into its slot; a frame-dedup batch's pool is
    expanded straight into its slot's ``clip`` by one ``index_select``
    (``out=``), the gather ``expand_dedup_batch`` makes, so its U_pad,
    which changes from batch to batch, never reaches the step."""
    def slot(batch: Mapping[str, torch.Tensor]) -> dict:
        """key -> (shape, dtype, device) of the batch's dense entries."""
        out = {k: (v.shape, v.dtype, v.device) for k, v in batch.items()
               if k not in ("frames", "clip_idx")}
        if "frames" in batch and "clip_idx" in batch:
            frames = batch["frames"]
            out["clip"] = (batch["clip_idx"].shape + frames.shape[1:],
                           frames.dtype, frames.device)
        return out

    def stack(*batches: Mapping[str, torch.Tensor]) -> dict:
        layout = slot(batches[0])
        out = {k: torch.empty((len(batches),) + shape, dtype=dtype,
                              device=device)
               for k, (shape, dtype, device) in layout.items()}
        for i, batch in enumerate(batches):
            if slot(batch) != layout:
                raise ValueError(f"make_device_stacker: batch {i}'s entries "
                                 f"{slot(batch)} differ from batch 0's "
                                 f"{layout}")
            for k, v in batch.items():
                if k not in ("frames", "clip_idx"):
                    out[k][i].copy_(v)
            if "frames" in batch and "clip_idx" in batch:
                frames = batch["frames"]
                torch.index_select(
                    frames, 0, batch["clip_idx"].reshape(-1).long(),
                    out=out["clip"][i].view(-1, *frames.shape[1:]))
        return out

    return stack


# the kernels' launch counters: a replay runs the kernels its capture
# recorded without the Python that counts them, so a graph adds the counts
# its capture made once per replay, and a count means kernels run
KERNEL_COUNTERS = ((fused_attention, "launches"),
                   (fused_attention, "backward_calls"),
                   (mel_frontend, "launches"))


class MultiTrainStep:
    """K train steps per dispatch; see ``make_multi_train_step``. After a
    capture: ``captures`` (1), ``capture_s`` (host seconds the capture
    took), ``replays``, ``pool_mb`` (device memory the capture reserved:
    the graph's private pool) and ``captured_counts`` (each of
    ``KERNEL_COUNTERS``' counts in one step)."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 suite: LossSuite, k: int, mesh: Mesh | None = None):
        if k < 1:
            raise ValueError(f"make_multi_train_step: k={k}")
        if mesh is not None and k > 1 and mesh.backend != "nccl":
            raise ValueError(
                f"make_multi_train_step(k={k}) under a {mesh.backend} process "
                "group: K > 1 replays a CUDA graph of the step, which must "
                "capture the step's collectives, and only NCCL's can be "
                f"captured ({mesh.backend}'s run through the host); use "
                "NCCL or --steps_per_dispatch 1")
        self.cfg, self.model, self.suite, self.k = cfg, model, suite, k
        self.mesh = mesh
        self.eager_step = make_train_step(cfg, model, suite, mesh)
        self.dispatches = self.captures = self.replays = 0
        self.pool_mb = self.capture_s = 0.0
        self.captured_counts: tuple = ()
        self.graph = None
        # set at the capture: the graph's static inputs and outputs, and
        # the arena it reads
        self._static = self._out = self._arena = None
        self._generator = None

    def __call__(self, state: TrainState, batches: Mapping[str, torch.Tensor],
                 seeds: Sequence[int],
                 arena: torch.Tensor | None = None) -> dict:
        if len(seeds) != self.k or any(v.shape[0] != self.k
                                       for v in batches.values()):
            raise ValueError(f"make_multi_train_step(k={self.k}): "
                             f"{len(seeds)} seeds, batches of "
                             f"{ {k: tuple(v.shape) for k, v in batches.items()} }")
        device = next(self.model.parameters()).device
        if self._generator is None:
            self._generator = torch.Generator(device=device)
        if device.type == "cuda" \
                and not state.optimizer.defaults["capturable"]:
            raise ValueError("make_multi_train_step on a CUDA device takes "
                             "the state of create_train_state(..., "
                             "capturable=True)")
        if device.type != "cuda" or self.dispatches == 0:
            # the CPU, and the card's first dispatch: the warm-up (the
            # allocator, cuDNN's choices, the kernels' build and shared
            # memory opt-in, Adam's state) before anything is captured
            metrics = self._eager(state, batches, seeds, arena)
        else:
            if self.graph is None:
                self._capture(state, batches, arena)
            metrics = self._replay(state, batches, seeds, arena)
        self.dispatches += 1
        return metrics

    def _eager(self, state, batches, seeds, arena) -> dict:
        per_step = [self.eager_step(state, {k: v[i] for k, v in
                                            batches.items()},
                                    self._generator.manual_seed(seed), arena)
                    for i, seed in enumerate(seeds)]
        return {k: torch.stack([m[k] for m in per_step])
                for k in per_step[0]}

    def _capture(self, state, batches, arena) -> None:
        """Capture one step on slot-sized static inputs. Capture runs no
        kernel: the Python that counts launches does run, so the counts
        are taken back and kept as the step's. A capture that fails raises
        naming what broke it; nothing runs in its place."""
        if any(p.grad is not None for p in state.params):
            raise RuntimeError("make_multi_train_step: gradients left from "
                               "an earlier step would be accumulated into "
                               "by every replay")
        device = next(self.model.parameters()).device
        self._static = {k: torch.empty_like(v[0]) for k, v in
                        batches.items()}
        self._arena = arena
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generator)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        counts = [getattr(obj, name) for obj, name in KERNEL_COUNTERS]
        t0 = time.perf_counter()
        try:
            # thread_local: the loader's threads may use the card (nvJPEG)
            # while the main thread captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = _step_body(self.cfg, self.model, self.suite, state,
                                 self._static, self._generator, arena,
                                 graphed=True, mesh=self.mesh)
        except RuntimeError as e:
            # ending a broken capture raises too: name the first error,
            # the op the capture could not take
            first = e
            while isinstance(first.__context__, RuntimeError):
                first = first.__context__
            raise RuntimeError(
                f"make_multi_train_step(k={self.k}): capturing the train "
                f"step in a CUDA graph failed, and no eager step ran in its "
                f"place: {str(first).splitlines()[0]}"
                + ("" if first is e else
                   f" (then: {str(e).splitlines()[0]})")) from first
        finally:
            captured = tuple(getattr(obj, name) - c for (obj, name), c in
                             zip(KERNEL_COUNTERS, counts))
            for (obj, name), c in zip(KERNEL_COUNTERS, counts):
                setattr(obj, name, c)
        self.captured_counts = captured
        self.capture_s = time.perf_counter() - t0
        self.pool_mb = (torch.cuda.memory_reserved(device) - reserved) / 2**20
        self.graph, self._out = graph, out
        self.captures += 1

    def _replay(self, state, batches, seeds, arena) -> dict:
        if arena is not self._arena or set(batches) != set(self._static):
            raise ValueError("make_multi_train_step: a dispatch must pass "
                             "the entries and the arena the graph was "
                             "captured with")
        for k, buf in self._static.items():
            if batches[k].shape[1:] != buf.shape \
                    or batches[k].dtype != buf.dtype:
                raise ValueError(f"make_multi_train_step: {k} is "
                                 f"{tuple(batches[k].shape[1:])} "
                                 f"{batches[k].dtype}, the graph's "
                                 f"{tuple(buf.shape)} {buf.dtype}")
        metrics = {k: torch.empty((self.k,) + v.shape, dtype=v.dtype,
                                  device=v.device)
                   for k, v in self._out.items()}
        for i, seed in enumerate(seeds):
            for k, buf in self._static.items():
                buf.copy_(batches[k][i])
            state.set_rate()
            self._generator.manual_seed(seed)
            self.graph.replay()
            for k, v in self._out.items():
                metrics[k][i].copy_(v)
            state.step += 1
            for (obj, name), n in zip(KERNEL_COUNTERS, self.captured_counts):
                setattr(obj, name, getattr(obj, name) + n)
        self.replays += self.k
        return metrics


def make_multi_train_step(cfg: Config, model: torch.nn.Module,
                          suite: LossSuite, k: int,
                          mesh: Mesh | None = None) -> MultiTrainStep:
    """Returns ``step_k(state, batches, seeds, arena=None) -> metrics``: K
    optimizer steps per dispatch (the JAX package's
    ``make_multi_train_step``, a ``lax.scan`` in one device program).
    ``batches`` maps each entry to a (K, B, ...) tensor on the model's
    device (``make_device_stacker``), ``seeds`` gives each step its
    generator's seed (``key_seq.next_seed``: step i draws what the i-th
    single step would, so a run is the same for every K), ``metrics``
    maps "loss" (and for task ALL "ex", "au", "va") to (K,) tensors.

    On the CPU: K eager steps (``make_train_step``), one after another.
    On a CUDA device (the state from ``create_train_state(...,
    capturable=True)``): the first dispatch runs K eager steps, the
    warm-up; the second captures one step in a CUDA graph on slot-sized
    static inputs with one generator registered with the graph; from then
    on each step copies its slot into the static inputs, fills the rate,
    reseeds the generator and replays: one graph launch and a few copies
    and fills in place of an eager step's thousands of launches (each
    kernel launch a runtime call). There is no fallback:
    a capture that fails raises. The graph lives as long as ``step_k``,
    with the arena (if any) it was captured with.

    Under a ``mesh`` the steps are ``make_train_step``'s data-parallel
    ones, and the graph captures their collectives: NCCL only; K > 1
    under another backend raises (gloo's collectives run through the
    host and cannot be captured), and none is ever skipped."""
    return MultiTrainStep(cfg, model, suite, k, mesh)


def make_eval_step(cfg: Config, model: torch.nn.Module,
                   suite: LossSuite, mesh: Mesh | None = None) -> Callable:
    """Returns ``step(batch, arena=None) -> (out (B, 21) f32, loss)``: the
    model in eval mode (running statistics, no dropout), no augmentation;
    ``arena`` as the train step's. Under a ``mesh`` ``out`` holds the rows
    of the global batch, gathered from every rank in rank order, and
    ``loss`` is the global batch's."""
    def step(batch: Mapping[str, torch.Tensor],
             arena: torch.Tensor | None = None):
        model.eval()
        with torch.no_grad():
            x = prep_batch(batch, train=False,
                           device_audio=cfg.device_audio, arena=arena,
                           sample_len=cfg.sample_len_frames)
            out = _forward(cfg, model, x)
            labels = _labels_of(batch)
            if mesh is not None:
                out, labels = global_rows(mesh, out, labels)
            loss, _ = task_loss(suite, cfg.task, out, labels)
        return out, loss

    return step
