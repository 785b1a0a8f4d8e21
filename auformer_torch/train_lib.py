"""Training driver (counterpart of auformer/train_lib.py; reference
train.py:106-336), on one device.

The reference's protocol: per-epoch 1/downsample_rate subsampling of the
labelled frames with a reshuffled mask (train.py:174-189), a one-shot
shuffled sequential sampler (or ``BlockShuffleSampler`` runs under
``locality_run``), per-epoch validation with composite scores, early
stopping on the task score, ``latest.pth`` / ``best.pth`` checkpoints in the
reference layout. The threaded loader and its prefetcher feed the step on
the card; the entry point raises without a GPU unless given
``device="cpu"``.

The JAX package's training feed runs as there: ``frame_dedup`` batches (a
pool of unique frames and a window map, expanded inside the step), the
wav arena under ``device_audio`` (each video's waveform on the card once
per run, ``audio_arena_mb``), ``locality_run`` and a ``profile_dir`` trace
of steps 10-15 of the first epoch. Flags of the JAX package that the port
does not run raise, naming their ROADMAP.md item: ``steps_per_dispatch >
1`` (A13) and host augmentation (no ``device_augment``, A10). Every model
of the zoo trains; only avformer freezes its streams.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from collections import defaultdict

import numpy as np
import torch

from .core.checkpointing import (EarlyStopper, load_checkpoint,
                                 model_state_dict, save_checkpoint)
from .core.config import Config
from .core.observability import RecorderMeter, StepTimer, profile
from .core.prng import key_seq, setup_seed
from .core.weights import load_weights
from .data import (Aff2CompDataset, BlockShuffleSampler, DataLoader,
                   Prefetcher, SubsetSequentialSampler)
from .data.wav_arena import build_wav_arena
from .infer import resolve_device
from .metrics import AccF1Metric, CCCMetric, MultiLabelAccF1, composite_scores
from .nn import build_model, loss_suite
from .parallel import (TrainState, create_train_state, make_eval_step,
                       make_train_step)

# the profile_dir window: steps [10, 15) of the first epoch, as in the JAX
# package
PROFILE_STEPS = (10, 15)


class AverageMeter:
    """reference utils.py:21-36."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def check_supported(cfg: Config) -> None:
    """Raise for the JAX package's training options the port does not run,
    each naming its ROADMAP.md item."""
    unported = [
        (not cfg.device_augment,
         "host (PIL) augmentation (queue A10); pass --device_augment"),
        (int(cfg.steps_per_dispatch or 1) > 1,
         "steps_per_dispatch > 1 (queue A13, CUDA graphs)"),
    ]
    for unsupported, what in unported:
        if unsupported:
            raise NotImplementedError(
                f"{what} is not ported to auformer_torch yet (ROADMAP.md)")


def device_batch_keys(model, cfg: Config, arena: bool = False,
                      dedup: bool = False) -> set:
    """Keys worth uploading for a step: the model's inputs and the labels,
    under ``device_audio`` the raw windows and their lengths instead of
    host features (with ``arena``: the int32 arena offsets instead of the
    windows), and with ``dedup`` the pool of unique frames and the window
    map instead of dense clips. The loader's batch also carries entries
    the step never reads, notably the raw right-aligned (B, 1, 441000)
    ``audio`` next to host features (113 MB per 64-batch)."""
    keys = set(getattr(model, "modes", ("clip", "audio_features")))
    keys |= {"AU", "EX", "VA"}
    if cfg.device_audio:
        keys |= {"audio_ofs" if arena else "audio", "audio_len"}
        keys.discard("audio_features")   # computed inside the step
    if dedup:
        keys |= {"frames", "clip_idx"}
        keys.discard("clip")             # expanded inside the step
    return keys


def to_device(batch: dict, keys: set, device: torch.device) -> dict:
    """The entries ``keys`` of a numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items() if k in keys}


def host_shard(ids, batch_size: int) -> tuple[list, int]:
    """(indices, local batch size): one process feeds the whole batch
    (multi-process input sharding comes with queue A7)."""
    return list(ids), batch_size


def _toggle_trace(trace: contextlib.ExitStack, start: bool, trace_dir: str,
                  device: torch.device) -> None:
    """Open the profiler's window in ``trace`` (``start``) or close it
    and write its trace. Profiling never stops training: a profiler that
    fails is logged and training goes on, as in the JAX package."""
    try:
        if start:
            trace.enter_context(profile(trace_dir, device))
        else:
            trace.close()
    except (RuntimeError, OSError) as e:
        logging.warning(f"profiler unavailable: {e}")


def evaluate(eval_step, loader, device: torch.device,
             num_step: int | None = None, keep: set | None = None) -> dict:
    """Validation sweep -> composite scores (reference train.py:106-169)."""
    metric_ex = AccF1Metric(ignore_index=7)
    metric_va = CCCMetric(ignore_index=-5.0)
    metric_au = MultiLabelAccF1(ignore_index=-1)
    total_loss, steps = 0.0, 0
    for batch in loader:
        if num_step is not None and steps >= num_step:
            break
        out, loss = eval_step(to_device(batch, keep or set(batch), device))
        out = out.cpu().numpy()
        total_loss += float(loss)
        steps += 1

        label_ex = batch["EX"].reshape(-1).astype(np.int64)
        label_ex[label_ex == -1] = 7
        metric_ex.update(np.argmax(out[:, 12:19], axis=1), label_ex)
        metric_va.update(np.tanh(out[:, 19:21]),
                         batch["VA"].astype(np.float32))
        metric_au.update(np.round(1.0 / (1.0 + np.exp(-out[:, :12]))),
                         batch["AU"].astype(np.float32))
    if steps == 0:  # empty/short val split (drop_last can consume it all)
        zero = {"acc": 0.0, "f1": 0.0, "score": 0.0}
        return {"EX": dict(zero), "AU": dict(zero),
                "VA": {"ccc_v": 0.0, "ccc_a": 0.0, "score": 0.0},
                "loss": 0.0}
    scores = composite_scores(metric_ex, metric_au, metric_va)
    scores["loss"] = total_loss / max(steps, 1)
    return scores


def train(cfg: Config, dataset=None, max_steps_per_epoch: int | None = None,
          epochs: int | None = None, device=None
          ) -> tuple[TrainState, list[dict]]:
    """Full training entry (reference train.py:172-336); returns the final
    state and one history entry per epoch. ``device``: ``cuda`` unless
    given (the tests pass ``"cpu"``)."""
    check_supported(cfg)
    device = resolve_device(device)
    root = setup_seed(cfg.seed, device)
    keys = key_seq(root)

    os.makedirs(cfg.exp_dir, exist_ok=True)
    log_file = os.path.join(
        cfg.exp_dir, f"{cfg.model_name}_{cfg.modality}_log.txt")
    logging.basicConfig(filename=log_file, level=logging.INFO,
                        format="[%(asctime)s.%(msecs)03d] %(message)s",
                        datefmt="%H:%M:%S", force=True)

    model = build_model(cfg, dtype=torch.float32)
    suite = loss_suite(model)
    if dataset is None:
        if cfg.data_backend == "synthetic":
            from .data.fixtures import ensure_synthetic
            ensure_synthetic(cfg)
        dataset = Aff2CompDataset(cfg)
    dataset.set_modes(list(model.modes))

    cfg.checkpoint_path = os.path.join(cfg.exp_dir, "pretrain")
    start_epoch = 0
    if cfg.resume:
        restored = load_checkpoint(cfg.checkpoint_path, "latest")
        if restored is not None:
            load_weights(model, restored)
            start_epoch = cfg.start_epoch
            logging.info("resumed from latest checkpoint")
    model.to(device)

    downsample = np.zeros(len(dataset), dtype=int)
    downsample[np.arange(0, len(dataset) - 1, cfg.downsample_rate)] = 1
    cfg.steps_per_epoch = int((dataset.train_ids * downsample).sum()
                              // max(cfg.batch_size, 1))

    # the wav arena (device_audio): each video's waveform goes to the
    # device once; batches then carry int32 window offsets instead of
    # 1.76 MB raw windows. Over the cap build_wav_arena returns None and
    # the batches keep shipping windows
    arena = None
    if (cfg.device_audio and "A" in cfg.modality.split(";")
            and cfg.audio_arena_mb > 0
            and "audio_features" in getattr(model, "modes", ())):
        plan = build_wav_arena(dataset, cap_mb=cfg.audio_arena_mb,
                               sample_len=cfg.sample_len_frames)
        if plan is not None:
            dataset.set_audio_arena(plan)
            arena = torch.from_numpy(plan.arena).to(device)

    state = create_train_state(cfg, model)
    train_step = make_train_step(cfg, model, suite)
    eval_step = functools.partial(make_eval_step(cfg, model, suite),
                                  arena=arena)
    # frame-dedup batches: a pool of unique frames and a (B, T) window map,
    # the clips gathered inside the step; host augmentation is per sample
    use_dedup = (bool(cfg.frame_dedup) and cfg.device_augment
                 and "clip" in getattr(model, "modes", ("clip",)))
    if use_dedup:
        dataset.set_frame_dedup(True)
    dev_keys = device_batch_keys(model, cfg, arena=arena is not None,
                                 dedup=use_dedup)
    stopper = EarlyStopper(cfg.early_stop_step, cfg.checkpoint_path)

    epochs = epochs if epochs is not None else cfg.epochs
    history = []
    recorder = RecorderMeter(max(epochs, 1))
    for epoch in range(start_epoch, epochs):
        np.random.shuffle(downsample)
        train_ids = np.nonzero(dataset.train_ids * downsample)[0]
        train_ids, local_bs = host_shard(train_ids, cfg.batch_size)
        # locality_run > 0: shuffle contiguous runs instead of single
        # indices so overlapping dilated windows hit the decode LRU
        run = int(cfg.locality_run or 0)
        sampler = (BlockShuffleSampler(train_ids, run,
                                       seed=cfg.seed * 100003 + epoch)
                   if run > 0
                   else SubsetSequentialSampler(train_ids, shuffle=True))
        loader = DataLoader(dataset, local_bs, sampler,
                            num_threads=cfg.host_threads, drop_last=True,
                            prefetch_batches=cfg.prefetch_depth)
        logging.info(f"Training {cfg.task}, Epoch:{epoch}")
        meters = defaultdict(AverageMeter)
        prefetch = Prefetcher(loader, depth=cfg.prefetch_depth)
        step_i = 0
        t_epoch = time.time()
        timer = StepTimer()
        trace = contextlib.ExitStack()     # the profile_dir window
        try:
            while (batch := prefetch.next()) is not None:
                if max_steps_per_epoch and step_i >= max_steps_per_epoch:
                    break
                timer.mark_data()
                if cfg.profile_dir and epoch == start_epoch \
                        and step_i in PROFILE_STEPS:
                    _toggle_trace(trace, step_i == PROFILE_STEPS[0],
                                  cfg.profile_dir, device)
                metrics = train_step(state, to_device(batch, dev_keys, device),
                                     keys(), arena)
                meters["loss"].update(float(metrics["loss"]))
                timer.mark_step()
                meters["data_ms"].update(timer.data_time * 1e3)
                meters["step_ms"].update(timer.step_time * 1e3)
                for k in ("ex", "au", "va"):
                    if k in metrics:
                        meters[k].update(float(metrics[k]))
                step_i += 1
                if step_i % cfg.log_every == 0:
                    logging.info(
                        f"epoch {epoch} step {step_i} "
                        f"loss {meters['loss'].avg:.4f} "
                        f"data {timer.data_time * 1e3:.1f}ms "
                        f"step {timer.step_time * 1e3:.1f}ms")
        finally:
            _toggle_trace(trace, False, cfg.profile_dir, device)
            # a step-capped epoch leaves the producer mid-epoch: stop it so
            # its decode threads do not contend with the next loader
            prefetch.stop()
        dt = time.time() - t_epoch
        logging.info(
            f"Total Loss,{meters['loss'].avg}, Ex:{meters['ex'].avg}, "
            f"AU:{meters['au'].avg}, VA:{meters['va'].avg} "
            f"({step_i} steps, {dt:.1f}s)")

        weights = model_state_dict(model)
        save_checkpoint(cfg.checkpoint_path, weights, name="latest")

        val_ids = np.nonzero(dataset.val_ids * downsample)[0]
        val_bs = cfg.batch_size * cfg.eval_batch_mult
        val_ids, local_val_bs = host_shard(val_ids, val_bs)
        val_loader = DataLoader(dataset, local_val_bs,
                                SubsetSequentialSampler(val_ids, shuffle=True),
                                num_threads=cfg.host_threads, drop_last=True,
                                prefetch_batches=cfg.prefetch_depth)
        num_eval = (max(int(len(val_ids) / local_val_bs), 1)
                    if len(val_ids) else 0)
        t_eval = time.time()
        scores = evaluate(eval_step, val_loader, device, num_step=num_eval,
                          keep=dev_keys)
        eval_s = time.time() - t_eval

        if cfg.task == "ALL":
            total_score = sum(scores[t]["score"] for t in ("EX", "AU", "VA"))
        else:
            total_score = scores[cfg.task]["score"]
        logging.info(f"Training,{cfg.task}, Epoch:{epoch}, "
                     f"score:{total_score:.4f} {scores}")
        # steps, wall seconds of the train loop and of the evaluation, the
        # StepTimer's mean data wait and step time
        history.append({"epoch": epoch, "score": total_score,
                        "loss": meters["loss"].avg, "scores": scores,
                        "steps": step_i, "seconds": dt, "eval_seconds": eval_s,
                        "data_ms": meters["data_ms"].avg,
                        "step_ms": meters["step_ms"].avg})

        recorder.update(epoch, meters["loss"].avg, 0.0,
                        scores.get("loss", 0.0), total_score * 100)
        if not stopper.is_continuable(weights, total_score):
            logging.info(f"validation: best score: {stopper.best_accuracy}")
            break
    recorder.save_json(os.path.join(cfg.exp_dir, "curves.json"))
    return state, history
