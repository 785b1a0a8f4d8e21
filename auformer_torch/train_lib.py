"""Training driver (counterpart of auformer/train_lib.py; reference
train.py:106-336), on one device or data parallel over the processes of
``torchrun``.

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
of steps 10-15 of the first epoch. ``steps_per_dispatch K`` > 1 gathers K
uploaded batches, stacks them on the device and runs them as one dispatch
(``parallel.step.make_multi_train_step``: on the card, replays of a CUDA
graph of the step; the sub-K epoch tail runs single steps); K = 1 is the
eager step. Without ``device_augment`` the loader augments each dense
clip on the host (data/transforms.py, the JAX package's default), seeded
per epoch and sample, a batch at a time in ``host_threads`` worker
processes (the eager step needs the GIL that loader threads augmenting
in-process would hold); frame dedup then stays
off, as in the JAX package. Every model of the zoo trains; only avformer
freezes its streams.

Under ``python -m torch.distributed.run --nproc_per_node N -m
auformer_torch.train`` each process joins the group its environment
describes (``core/mesh.py::maybe_init_distributed``: NCCL on the GPUs),
takes ``cuda:{LOCAL_RANK}``, starts from rank 0's weights and trains one
global-batch program (``parallel/step.py`` under a mesh): each rank loads
an equal, disjoint shard of the ids at batch_size / N (``host_shard``),
the validation rows are gathered so that every rank scores the same set
and the early stopper cannot diverge, frame dedup stays off at N > 1 (as
in the JAX package), and rank 0 alone writes the log file, the
checkpoints and the curves, the others waiting at a barrier.
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
import torch.distributed as dist

from .core.checkpointing import (EarlyStopper, load_checkpoint,
                                 model_state_dict, save_checkpoint)
from .core.config import Config
from .core.mesh import Mesh, make_mesh, maybe_init_distributed
from .core.observability import RecorderMeter, StepTimer, profile
from .core.prng import key_seq, setup_seed
from .core.weights import load_weights
from .data import (Aff2CompDataset, BlockShuffleSampler, DataLoader,
                   Prefetcher, SubsetSequentialSampler, shard_indices)
from .data.transforms import AugmentPool
from .data.wav_arena import build_wav_arena
from .infer import resolve_device
from .metrics import AccF1Metric, CCCMetric, MultiLabelAccF1, composite_scores
from .nn import build_model, loss_suite
from .parallel import (TrainState, create_train_state, make_device_stacker,
                       make_eval_step, make_multi_train_step, make_train_step)

# the profile_dir window: steps [10, 15) of the first epoch, as in the JAX
# package (under steps_per_dispatch, ``profile_window``)
PROFILE_STEPS = (10, 15)


def profile_window(k: int) -> tuple[int, int]:
    """The steps [first, stop) of the first epoch that the ``profile_dir``
    trace covers when each dispatch runs ``k`` steps: it opens at the
    first dispatch that starts at or after step 10 and closes at the first
    at or after step 15 (at least one dispatch later). The JAX package
    tests ``step_i == 10`` and ``== 15``, which a step count that moves by
    K > 1 may never meet (ROADMAP.md C7)."""
    first = -(-PROFILE_STEPS[0] // k) * k
    return first, max(-(-PROFILE_STEPS[1] // k) * k, first + k)


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


def host_shard(ids, batch_size: int, host_id: int | None = None,
               num_hosts: int | None = None) -> tuple[list, int]:
    """This process's (indices, local batch size) of a data-parallel
    world (the JAX package's ``host_shard``): the global batch stays
    ``batch_size``, and each of the ``num_hosts`` processes (default: the
    process group's world, 1 without one) loads a disjoint
    batch_size / num_hosts slice of it. The shards are cut to one length,
    so that every rank runs the same number of steps (a rank with one step
    more would wait forever in its first collective); the samples dropped
    for that are logged. A batch that does not divide raises. One process
    takes every id."""
    grouped = dist.is_available() and dist.is_initialized()
    if num_hosts is None:
        num_hosts = dist.get_world_size() if grouped else 1
    if host_id is None:
        host_id = dist.get_rank() if grouped else 0
    if num_hosts == 1:
        return list(ids), batch_size
    if batch_size % num_hosts:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{num_hosts} processes")
    local = shard_indices(ids, host_id, num_hosts)
    dropped = len(ids) - num_hosts * (len(ids) // num_hosts)
    if dropped:
        logging.info(f"host_shard: {dropped}/{len(ids)} samples dropped "
                     f"for equal {num_hosts}-process shard lengths")
    return local[:len(ids) // num_hosts], batch_size // num_hosts


def _gather_eval_rows(batch: dict, mesh: Mesh | None) -> dict:
    """The EX, VA and AU labels of the global validation batch (every
    rank's rows in rank order, as the eval step gathers the outputs), so
    that every rank scores the same rows; one process's batch as it is."""
    if mesh is None:
        return batch
    keys = ("EX", "VA", "AU")
    local = [np.asarray(batch[k], np.float32).reshape(len(batch[k]), -1)
             for k in keys]
    widths = [a.shape[1] for a in local]
    full = mesh.all_gather_rows(torch.from_numpy(
        np.concatenate(local, 1)).to(mesh.device)).cpu().numpy()
    edges = np.cumsum([0] + widths)
    return {k: full[:, a:b].astype(np.asarray(batch[k]).dtype)
            for k, a, b in zip(keys, edges[:-1], edges[1:])}


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
             num_step: int | None = None, keep: set | None = None,
             mesh: Mesh | None = None) -> dict:
    """Validation sweep -> composite scores (reference train.py:106-169).
    Under a ``mesh`` the eval step returns the global batch's rows and
    the labels are gathered to match (``_gather_eval_rows``)."""
    metric_ex = AccF1Metric(ignore_index=7)
    metric_va = CCCMetric(ignore_index=-5.0)
    metric_au = MultiLabelAccF1(ignore_index=-1)
    total_loss, steps = 0.0, 0
    for batch in loader:
        if num_step is not None and steps >= num_step:
            break
        out, loss = eval_step(to_device(batch, keep or set(batch), device))
        out = out.cpu().numpy()
        batch = _gather_eval_rows(batch, mesh)
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
    device = resolve_device(device)
    # under torchrun: join the process group before the model is placed
    maybe_init_distributed(device)
    mesh = make_mesh(cfg.mesh_shape, device)
    lead = mesh is None or mesh.rank == 0     # writes the files
    root = setup_seed(cfg.seed, device)
    keys = key_seq(root)

    os.makedirs(cfg.exp_dir, exist_ok=True)
    log_file = os.path.join(
        cfg.exp_dir, f"{cfg.model_name}_{cfg.modality}_log.txt")
    if lead:
        logging.basicConfig(filename=log_file, level=logging.INFO,
                            format="[%(asctime)s.%(msecs)03d] %(message)s",
                            datefmt="%H:%M:%S", force=True)
    else:
        logging.basicConfig(level=logging.WARNING, force=True)

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
        # the JAX package's orbax latest/ first, latest.pth second
        restored = load_checkpoint(cfg.checkpoint_path, "latest",
                                   cfg.model_name,
                                   target=model_state_dict(model))
        if restored is not None:
            load_weights(model, restored)
            start_epoch = cfg.start_epoch
            logging.info("resumed from latest checkpoint")
    model.to(device)
    if mesh is not None:
        mesh.broadcast_module(model)      # every rank starts from rank 0's

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

    # steps_per_dispatch K > 1: K uploaded batches stacked on the device
    # and run as one dispatch; on the card a CUDA graph of the step, whose
    # Adam must be capturable (its eager steps take the same one)
    spd = max(int(cfg.steps_per_dispatch or 1), 1)
    state = create_train_state(cfg, model,
                               capturable=spd > 1 and device.type == "cuda")
    train_step = make_train_step(cfg, model, suite, mesh)
    multi_step = (make_multi_train_step(cfg, model, suite, spd, mesh)
                  if spd > 1 else None)
    stacker = make_device_stacker() if spd > 1 else None
    window = profile_window(spd)
    eval_step = functools.partial(make_eval_step(cfg, model, suite, mesh),
                                  arena=arena)
    # frame-dedup batches: a pool of unique frames and a (B, T) window map,
    # the clips gathered inside the step (or into the stack under K > 1);
    # host augmentation is per sample; one process only, as in the JAX
    # package (each rank's pool would index its own rows)
    use_dedup = (bool(cfg.frame_dedup) and cfg.device_augment
                 and (mesh is None or mesh.world == 1)
                 and "clip" in getattr(model, "modes", ("clip",)))
    if use_dedup:
        dataset.set_frame_dedup(True)
    dev_keys = device_batch_keys(model, cfg, arena=arena is not None,
                                 dedup=use_dedup)
    stopper = EarlyStopper(cfg.early_stop_step, cfg.checkpoint_path)

    def run(batches: list) -> dict:
        """Train on the uploaded ``batches``: single steps, or one
        dispatch of K (its values read with one sync); each metric's
        per-step values."""
        if multi_step is None or len(batches) < spd:
            per_step = [train_step(state, b, keys(), arena) for b in batches]
            return {k: [float(m[k]) for m in per_step] for k in per_step[0]}
        metrics = multi_step(state, stacker(*batches),
                             [keys.next_seed() for _ in batches], arena)
        return {k: v.tolist() for k, v in metrics.items()}

    epochs = epochs if epochs is not None else cfg.epochs
    history = []
    recorder = RecorderMeter(max(epochs, 1))
    # host AutoAugment unless the step augments on the device, in worker
    # processes; each sample's generator is seeded from the epoch's seed
    # and its index
    aug_pool = (None if cfg.device_augment or start_epoch >= epochs
                else AugmentPool(cfg.host_threads, cfg.batch_size,
                                 dataset.clip_bytes))
    for epoch in range(start_epoch, epochs):
        np.random.shuffle(downsample)
        dataset.set_aug(not cfg.device_augment, aug_pool)
        dataset.aug_seed = cfg.seed * 100003 + epoch
        train_ids = np.nonzero(dataset.train_ids * downsample)[0]
        train_ids, local_bs = host_shard(train_ids, cfg.batch_size)
        # locality_run > 0: shuffle contiguous runs instead of single
        # indices so overlapping dilated windows hit the decode LRU
        run_len = int(cfg.locality_run or 0)
        sampler = (BlockShuffleSampler(train_ids, run_len,
                                       seed=cfg.seed * 100003 + epoch)
                   if run_len > 0
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
        pend: list = []    # the uploaded batches of the dispatch in the making

        def record(batches: list) -> None:
            """Run ``batches`` and meter them: per-step losses, and the
            StepTimer's means over them."""
            nonlocal step_i
            metrics = run(batches)
            timer.mark_step()
            timer.end_dispatch(len(batches))
            for k, values in metrics.items():
                for v in values:
                    meters[k].update(v)
            meters["data_ms"].update(timer.data_time * 1e3, len(batches))
            meters["step_ms"].update(timer.step_time * 1e3, len(batches))
            step_i += len(batches)
            if step_i // cfg.log_every > (step_i - len(batches)) \
                    // cfg.log_every:
                logging.info(
                    f"epoch {epoch} step {step_i} "
                    f"loss {meters['loss'].avg:.4f} "
                    f"data {timer.data_time * 1e3:.1f}ms "
                    f"step {timer.step_time * 1e3:.1f}ms")

        try:
            while (batch := prefetch.next()) is not None:
                if max_steps_per_epoch \
                        and step_i + len(pend) >= max_steps_per_epoch:
                    break
                timer.mark_data()
                if cfg.profile_dir and lead and epoch == start_epoch \
                        and not pend and step_i in window:
                    _toggle_trace(trace, step_i == window[0],
                                  cfg.profile_dir, device)
                pend.append(to_device(batch, dev_keys, device))
                if len(pend) == spd:
                    batches, pend = pend, []
                    record(batches)
                else:
                    timer.mark_step()
        finally:
            _toggle_trace(trace, False, cfg.profile_dir, device)
            # a step-capped epoch leaves the producer mid-epoch: stop it so
            # its decode threads do not contend with the next loader
            prefetch.stop()
        if pend:          # the epoch's tail, fewer than K: single steps
            record(pend)
        dt = time.time() - t_epoch
        logging.info(
            f"Total Loss,{meters['loss'].avg}, Ex:{meters['ex'].avg}, "
            f"AU:{meters['au'].avg}, VA:{meters['va'].avg} "
            f"({step_i} steps, {dt:.1f}s)")

        weights = model_state_dict(model) if lead else None
        if lead:
            save_checkpoint(cfg.checkpoint_path, weights, name="latest")

        dataset.set_aug(False)
        val_ids = np.nonzero(dataset.val_ids * downsample)[0]
        n_val_global = len(val_ids)
        val_bs = cfg.batch_size * cfg.eval_batch_mult
        val_ids, local_val_bs = host_shard(val_ids, val_bs)
        val_loader = DataLoader(dataset, local_val_bs,
                                SubsetSequentialSampler(val_ids, shuffle=True),
                                num_threads=cfg.host_threads, drop_last=True,
                                prefetch_batches=cfg.prefetch_depth)
        num_eval = (max(int(len(val_ids) / local_val_bs), 1)
                    if len(val_ids) else 0)
        # equal shards and drop_last may leave up to world * local batch - 1
        # validation samples unscored: say so
        n_scored = min(num_eval * local_val_bs, len(val_ids)) \
            * (1 if mesh is None else mesh.world)
        if n_scored < n_val_global:
            logging.info(f"val: scoring {n_scored}/{n_val_global} samples "
                         "(equal shards + drop_last truncation)")
        t_eval = time.time()
        scores = evaluate(eval_step, val_loader, device, num_step=num_eval,
                          keep=dev_keys, mesh=mesh)
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
        go_on = stopper.is_continuable(weights, total_score)
        if mesh is not None:
            mesh.barrier()        # rank 0's checkpoints are on disk
        if not go_on:
            logging.info(f"validation: best score: {stopper.best_accuracy}")
            break
    if aug_pool is not None:
        aug_pool.close()
    if lead:
        recorder.save_json(os.path.join(cfg.exp_dir, "curves.json"))
    return state, history
