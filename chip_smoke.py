#!/usr/bin/env python3
"""Drive the auformer_torch main path on one CUDA GPU and hold each
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failed check exits non-zero):

  env      torch / CUDA versions, the card's name and power limit
  build    nvcc for every kernel under auformer_torch/csrc, all at once:
           ptxas registers and spills, tensor-core instructions in the SASS
  kernels  each kernel at every main-path shape and dtype, on the inputs
           the main path gives it (attention: the strided head split of a
           fused QKV projection), against its plain version on the card:
           max error beside its tolerance, kernel / plain / library time,
           roofline bound
  slice    full-width avformer clip-batch inference (112x112, T=16, B=8,
           random reference-layout weights from a seed): launch counts of
           one bf16 (the default) and one fp32 forward, fp32 logits against
           the same port on the CPU, clips/s in fp32 and bf16, a profiled
           bf16 forward (device time, kernels per forward), the same with
           f32 convolution and Linear weights (autocast's per-call casts),
           and run_inference into a temporary directory
  sweep    the full-width dense sweep of a synthetic 2,100-frame video
           (30 fps timestamps, 70 s wav; buckets of 1280 and 820 label
           frames): launch counts per bucket and of run_inference_sweep,
           phase-mel features of 16 windows against the per-window route,
           fp32 sweep logits against the fp32 clip path, the forced
           per-window route against the phase route, label frames/s in
           bf16, device ms, kernels and ms by stage per bucket, idle share,
           peak memory, the submission files of run_inference_sweep, and
           the same bf16 sweep with f32 convolution and Linear weights,
           which autocast casts at every call (prepare_inference rounds
           them once)
  dataset  a synthetic Aff-Wild2-layout test split written by the port's
           fixtures (three videos of 2,100, 1,200 and 700 frames, 112x112
           JPEG q90, 30 fps, wavs of each video's length + 0.5 s) and a
           .pth of the seeded random weights; ``python -m
           auformer_torch.test_aff2`` (its ``main``) over it in bf16: the
           FrameStore, the native decoder in a decode worker process,
           sweep_stream and the dense sweep, launch counts per bucket,
           the submission files. Then in fp32: the dataset-fed sweep
           against the array-fed run_inference_sweep on the same decoded
           frames, dataset-fed run_inference (DataLoader, host features)
           against the sweep on 64 label frames, the strict_parity sweep
           of the 700-frame video, decoded frames against their source
           images. Then the decoder, its rate alone, the worker's
           start-up, the worker alone per video (decode against pipe
           transfer), sweep_serve_benchmark's end-to-end label frames/s
           (decode, wait and sweep seconds) through the worker and through
           a decode thread, beside the array-fed rate, in bf16
  packed   on the same split, before it is removed: the packed
           cross-video route (packed_sweep_stream) in fp32 against the
           per-video sweep_stream through the decode worker's registered
           shared ring and through a thread, and with one video's
           timestamps jittered onto the per-video fallback route; launches
           per packed bucket; the ring (backing, size, registration), its
           releases (made, blocked on their copy's event), host bytes
           copied into chunks per bucket; sweep_serve_benchmark(packed=True)
           label frames/s in bf16 through the worker (the main path) and a
           thread beside the per-video and array-fed rates; then
           postprocess.main over test_aff2.main's submission, each video's
           frame count from a meta.json side file
  zoo      the other served models at full width (random reference-layout
           weights from the seed): vformer, sformer (tasks AU and VA),
           tformer, dsformer, vggformer, i3d, mc3d (T=16, or T=1 for the
           single-frame models, dilation 3), van, emonet (256x256, its
           full width), audio and tsav (raw audio, the mel kernel) and the
           resnet baseline. Per model, a B=8 clip forward: launch counts of
           one bf16 forward (the main path) and one fp32, fp32 logits on
           the card against the same port on the CPU, bf16 against fp32,
           clips/s, device ms and idle share per forward in bf16. Then
           the sweep phase's 2,100-frame video through VformerSweep (fp32
           against the fp32 clip path on 16 label frames, launches per
           bucket, bf16 label frames/s, device ms and kernels per bucket) and
           through SingleFrameSweep for sformer and van, and a synthetic
           1,024-frame 256x256 array through emonet's (fp32 against each
           model's clip forward on 64 frames, launches per bucket, label
           frames/s, device ms per bucket, peak memory), and
           run_inference_sweep of vformer over the dataset phase's split
  ingest   the port's host modules without cv2, PIL or a video decoder:
           (a) a PNG-aligned test split (one 300-frame video of 112x112
           fixture frames written by fixtures.write_png, and its wav)
           packed by create_image_store(reencode_png=True), PNGs read by
           data/png.py and re-encoded at q95 by nvJPEG, into the split's
           image store under their .png keys (the native reader takes
           the split's .jpg names to them, ROADMAP C11): decoded frames
           against their PNG sources, PNG decode and JPEG encode
           frames/s, both again on 100 frames whose rows are all Paeth
           (read_png's slowest filter), then ``python -m
           auformer_torch.test_aff2`` (its ``main``) over the store in
           bf16, attention launches counted;
           (b) jpeg_compression at probability 1.1 on a (16, 112, 112, 4)
           clip through nvJPEG: the mask channel unchanged, the error
           against the source, ms per clip; (c) on the CPU,
           random_color_augment and RandomColorAugment ms per
           (16, 112, 112, 3) clip and the SHA-256 of the HSV pair over
           all 2^24 inputs against PIL's (PIL_HSV_DIGESTS); (d) Video,
           probe_video_meta, extract_timestamps and
           postprocess.video_frame_counts over tests/data/videos/
           against expected.json, then postprocess.main over a video
           directory without meta.json files
           through the decode worker (the submission files); the split is
           removed after it
  orbax    the JAX package's checkpoints, read without orbax: (a) the zstd
           decoder built from data/native/zstd_decode.cpp, every committed
           checkpoint of tests/data/orbax/ (OCDBT and zarr directories)
           read by core/orbax_reader.py, each leaf's SHA-256 against
           expected.json, and where this machine has a libzstd.so.1 its
           decode of the fixtures' zstd frames against the port's (a
           cross-check only); (b) the JAX avformer's full-width tree
           (avformer_tree.json) filled from the seed, written as the JAX
           package's save_checkpoint writes it (fixtures.
           write_orbax_checkpoint) into experiments/avformer/pretrain/
           best/ of one work directory and as the .pth of
           state_dict_from_jax of it into another; the checkpoint's bytes,
           read s and MB/s, the state dict equal to state_dict_from_jax;
           ``python -m auformer_torch.test_aff2`` (its ``main``) over the
           dataset phase's split in bf16 in both: the orbax run reports
           best/ and launches 11 attention kernels per bucket, and its
           predictions and submission files equal the .pth run's bit for
           bit; the split is removed after it
  decode   video frames (no model): (a) NVDEC's caps for H.264 and
           MPEG-4 part 2, or the driver's refusal (this card's container
           refuses them), and the H.264 fixtures' frames raising naming
           A9; (b) tests/data/videos_decode/: every fixture's count and
           timestamps (the B-frame MP4's in the decoder's output order)
           against expected.json, the MJPEG fixture's frames on the card
           against the JAX package's cv2 frames (mjpg_112.npz, within
           MJPG_MAX and MJPG_MEAN) and against the plain conversion of
           nvJPEG's planes, bit for bit; (c) the yuv_rgb kernel at
           1280x720 against its plain version on the card, bit for bit,
           on the main path's 4:2:0 planes, its device ms beside its
           bound; (d) a
           300-frame 1280x720 30 fps MJPEG AVI written here (nvJPEG q90)
           through Video.frames() on the card, the main path: frames/s,
           s per frame, 300 yuv_rgb launches, frame_tensors()' rate,
           read_RGB at five indices equal to frames(), two runs of 30
           frames' nvJPEG planes converted by the plain version on the
           CPU equal to the card's, the frames' error against their
           sources
  quickstart
           ``python -m auformer_torch.quickstart`` (its ``main``, no
           device argument), the port's examples/quickstart.py: its
           synthetic split (four 40-frame 64x64 videos: train, train, val,
           test), 2 epochs of vformer fp32 training at B=8 with the
           loader's host AutoAugment, evaluation, and test-split inference
           with the submission files; launches (4 attention forwards per
           forward, 4 backward calls per step), seconds for the fixture,
           each epoch and the inference, train clips/s, inference label
           frames/s; the trained weights' inference on the CPU against the
           card's; before it the attention gradient check at its spatial
           (16 tokens, head dim 32, 32 rows) and temporal (5, 64, 8) sites
  train    a synthetic train/val split written by the port's fixtures
           (videos of 1,100, 1,100, 600 and 100 frames: train, train,
           val, test; 112x112 JPEG q90). Before any training: the
           attention autograd Function (kernel forward, recomputing
           backward) against autograd through the plain version at the
           fusion head's and the spatial site in both dtypes, with forward,
           backward, plain and SDPA forward+backward times; the fusion
           head's to_qkv gradients after one backward of the full model
           against the plain route's; one fp32 train step (B=4, dropout 0,
           symmetric clips) against the same step on the CPU; the
           augmentation stages at every op against the CPU. Then the main
           path, ``python -m auformer_torch.train`` (its ``main``) at
           B=64 in bf16 with --device_augment for 2 epochs (launch
           counts), 1 epoch with --resume, 5 steps with --device_audio, a
           30-step overfit of one batch, the checkpoint round trip, and
           the numbers: clips/s, StepTimer data and step ms, device ms,
           kernels and idle share per step, eval s, peak memory, loss per
           epoch, and the seconds of each part of the phase (``part_s``).
           Between them, the ``feed`` sub-phase (its own line):
           one epoch each of ``train.main --device_audio`` dense with raw
           windows and ``--frame_dedup`` with the default wav arena (the
           slice's main path), both ``--locality_run 64``, and the default
           shuffled sampler dense with raw windows; per run clips/s,
           StepTimer data and step ms, JPEG decodes and host-to-device
           bytes per batch (counted by wrapping the reader's decode_batch
           and train_lib.to_device here), arena MB, peak memory, attention
           launches; on the card the first dedup batch expanded and its
           arena windows gathered equal the dense batch's (torch.equal),
           one fp32 step through each feed gives one loss (rel 1e-5), and
           a --profile_dir run of 16 steps writes a trace of steps 10-15
           that holds the attention kernel's events (wall, device busy,
           kernels, copies and CUDA runtime calls per step). The
           ``host_aug`` sub-phase (its own line): one epoch each of
           ``train.main --device_audio --locality_run 64`` (dense clips,
           the default wav arena) with the loader's host AutoAugment in
           worker processes (h, no --device_augment: the slice's main
           path) and with --device_augment (d); per run clips/s,
           StepTimer data and step ms, attention launches and backward
           calls (checked), peak memory; (h)'s first batch equal at 1 and
           4 loader threads; 4 steps of (h) augmenting in the loader's
           threads instead; on this machine's CPU the digest of the
           port's train_augment against PIL's (a constant: no PIL here),
           its ms per (64, 16) batch in one thread and a loader batch at
           4 threads plain, augmenting in its threads and through the
           worker pool. Then the
           zoo: one fp32 train step of each of the twelve other models
           (64x64, T=2 or 1, B=4, dropout 0) on the card
           against the CPU; the main path ``python -m auformer_torch.train
           --model_name vformer --device_augment`` (its ``main``) at B=64
           in bf16 for 1 epoch (4 attention launches and 4 backward calls
           per step), its checkpoint round trip, 5 profiled steps with the
           attention forward and backward device ms per step at each site
           (spatial and temporal); and 3 bf16 steps of every other zoo
           model at full width (emonet 256x256) on ready device batches:
           attention per step, device ms, kernels and peak memory. The
           ``graph`` sub-phase (its own line, ``--steps_per_dispatch K``:
           a CUDA graph of the step): avformer and vformer in fp32 at
           full width, B=64, augmentation and dropout on, 4 steps as 2
           dispatches of K = 2 (the warm-up, then a capture and its
           replays) against 4 eager steps from the same weights and seeds
           with the same capturable Adam (losses, parameters, BatchNorm
           statistics, Adam's moments: equal wherever two eager runs are,
           else within twice their spread, all under deterministic
           algorithms); two epochs of the fed loop (``feed`` (b)'s flags)
           at K = 4 beside (b)'s K = 1 numbers, its
           attention launches counted per replay; its --profile_dir trace
           (steps 12-15), which must hold the attention kernel's events
           from replays; every other zoo model's bf16 steps graphed at
           K = 2 with the same check on its loss, wall and device ms and
           the idle share per step beside the eager ones; and a host sync
           put into the step, whose capture must raise. The ``dp``
           sub-phase (its own line, data parallelism on the one card):
           (a) an NCCL world of one in a process of ``torch.distributed.
           run`` (this file's ``dp_worker``): avformer's fp32 step (B=16,
           augmentation and dropout on) under the mesh against the step
           without a process group (loss, gradients, BatchNorm
           statistics, tests/test_parallel.py's tolerances), the
           collectives and bytes per step, 8 steps as 2 dispatches of
           K = 4 with the collectives captured against eager, the cost
           of the global batch's random draws at 8 ranks of 8 rows, then
           ``train.main`` at B=64 in bf16 with --device_augment for an
           epoch (the data-parallel main path: attention 11 per step and
           per eval step, 3 backward calls per step; clips/s beside the
           train phase's epochs without a process group), and the train
           phase's step on ready batches (bf16, B=64) with and without
           the process group in turns; (b) a gloo world
           of two processes sharing the card (``parallel/multiproc.py``),
           avformer and vformer in fp32 at a global B=16: each rank's
           step and gathered eval rows against the world-1 step here, and
           the step ms of this test rig; (c) in that world,
           run_inference_sweep over two synthetic videos of 300 and 307
           frames, one per rank, against world 1 here (rank 0 alone
           writes the files)

Then one JSON line of per-kernel results: for attention, sums over one
sweep bucket's calls in bf16 (the main path's dtype), with the per-bucket
sums in both dtypes (``per_bucket``, and ``per_packed_bucket`` for a full
2048-clip packed bucket), the clip path's per-forward sums
(``per_forward``) and the train step (``train_step``: per call at the
fusion head's site beside its launches per step, and the traced device ms
per step of the kernel and of the backward; ``vformer``: per call at its
spatial and temporal sites in both dtypes, beside SDPA's forward +
backward, and the trace's forward and backward device ms per step by
site; ``quickstart``: per forward and per site of the quickstart's
vformer, and its gradient check); ``launches`` counts the slice's, the
sweep's, the dataset's, the packed, the zoo, the ingest and orbax phases'
test_aff2 runs (orbax: the run from best/), the decode phase's frames()
(yuv_rgb), the quickstart's run, the train phase's,
the feed's, the host_aug's and the graph's main path runs
(``launches_by_path``; ``zoo`` sums the zoo phase's bf16 main path runs;
``feed`` is the --frame_dedup + wav arena epoch, ``host_aug`` the (h)
epoch, ``graph`` the --frame_dedup + wav arena epoch at
--steps_per_dispatch 4, its replays counted, ``dp`` the NCCL world of
one's epoch, counted in its process), and ``zoo_sites`` lists the zoo's
attention
sites in both dtypes. Then the nvidia-smi name/power line, and last
``{"ok": true, "device": {...}}``. Without a GPU, or outside a checkout
of the repository, it exits non-zero and prints no result.

Device times come from torch.profiler. A session that records no device
time is run again, up to PROFILER_SESSIONS times; after that a kernel's
``ms`` is its CUDA-event time and the other device numbers are null. The
``kernels`` and ``done`` lines count the sessions, those without device
time, and the cases timed by events.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import os
import pickle
import random
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
SEED = 0
BATCH = 8            # clips per forward
FRAMES = 16
IMAGE = 112
HEADS = 8

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
TENSOR_CORE_KERNELS = ("attention", "mel")   # yuv_rgb is integer work
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

PROFILER_SESSIONS = 4  # profiler sessions tried per measurement
PROFILER_LOG = {"sessions": 0, "sessions_without_device_time": 0,
                "event_timed_cases": 0}

# a full packed bucket: the default cap (2048 label frames on CUDA)
PACKED_BUCKET = 2048
# the dense sweep's synthetic video and the bucket the default (2048) cap
# splits it into: 1280 + 820 label frames
SWEEP_FRAMES = 2100
SWEEP_WAV_SECS = 70
SWEEP_BSIZE = 1280
SECOND_FRAMES = 300  # a second, shorter video for run_inference_sweep
# emonet's SingleFrameSweep: a synthetic 256x256 frame array in buckets of
# 512 (the zoo phase)
EMONET_FRAMES = 1024
EMONET_SWEEP_BUCKET = 512
LABEL_FRAME = 48     # T=16, dilation 3
# 16 label frames whose windows are held against the per-window route and
# the clip path: short (ts < 10 s), full, truncated by the end of the file
# (ts > 65 s), both buckets' first and last rows and the boundary at 1280
FEATURE_WINDOWS = (0, 1, 5, 47, 48, 299, 300, 600, 1000, 1279, 1280, 1281,
                   1950, 2000, 2098, 2099)

# the quickstart phase: python -m auformer_torch.quickstart's split (four
# videos of 40 frames: train, train, val, test) at B=8 (T=4), its eval and
# test batches
QUICKSTART_FRAMES = 40
QUICKSTART_BATCH = 8

# attention sites: (path, name, tokens, head dim, batch, launches per call)
# with 8 heads; a call is one clip-batch forward (slice) or one sweep
# bucket, whose trunk batch is the bucket, its history frames and the
# black frame
ATTENTION_SITES = (("slice", "spatial", 49, 32, BATCH * FRAMES, 1),
                   ("slice", "temporal", 17, 64, BATCH, 3),
                   ("slice", "au_tokens", 12, 32, BATCH, 7),
                   ("sweep", "spatial", 49, 32,
                    SWEEP_BSIZE + LABEL_FRAME + 1, 1),
                   ("sweep", "temporal", 17, 64, SWEEP_BSIZE, 3),
                   ("sweep", "au_tokens", 12, 32, SWEEP_BSIZE, 7),
                   ("packed", "spatial", 49, 32,
                    PACKED_BUCKET + LABEL_FRAME + 1, 1),
                   ("packed", "temporal", 17, 64, PACKED_BUCKET, 3),
                   ("packed", "au_tokens", 12, 32, PACKED_BUCKET, 7),
                   # the zoo's new sites, per B=8 clip forward of its model
                   ("zoo", "sformer_va_head", 2, 32, BATCH, 2),
                   ("zoo", "tformer_au_tokens", 12, 32, BATCH * FRAMES, 2),
                   ("zoo", "tformer_temporal_1536", 17, 64, BATCH, 3),
                   ("zoo", "vggformer_spatial", 16, 32, BATCH * FRAMES, 1),
                   ("zoo", "audio_au_tokens", 12, 32, BATCH, 2),
                   ("zoo", "dsformer_spatial", 49, 32, BATCH, 2),
                   # emonet's AU head over a SingleFrameSweep bucket
                   ("zoo", "emonet_sweep_au_tokens", 12, 32,
                    EMONET_SWEEP_BUCKET, 2),
                   # the quickstart's vformer (64x64: a 4x4 map; T=4 + 1
                   # tokens) per B=8 forward, fp32 on its path
                   ("quickstart", "spatial", 16, 32, QUICKSTART_BATCH * 4,
                    1),
                   ("quickstart", "temporal", 5, 64, QUICKSTART_BATCH, 3))
ATTN_PER_CALL = 11
ATTN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-3)}
MEL_ATOL = 2e-3          # normalized units (0.04 dB): sum order only
SLICE_TOL = (2e-3, 2e-4)  # rtol, atol: card fp32 vs CPU fp32 logits
SWEEP_TOL = (2e-3, 2e-4)  # rtol, atol: fp32 sweep vs fp32 clip path
FEATURE_ATOL = 1e-4       # normalized units: phase-mel vs per-window, f32

# the dataset phase's test split: 4,000 label frames, past the decode
# worker's threshold (2,000)
DATASET_FRAMES = (2100, 1200, 700)
PLUMBING_ATOL = 1e-6      # dataset-fed vs array-fed sweep, same frames
# label frames of the clip-path check: video 0 rows whose 10 s window lies
# whole inside its 70.5 s wav (10 s <= ts <= 65.5 s)
CLIP_ROWS = range(1000, 1064)
# decoded frame vs its source image, uint8 levels: JPEG q90 with 4:2:0
# chroma of a gradient with a moving blob and N(0, 0.02) noise
JPEG_MEAN_TOL, JPEG_MAX_TOL = 6.0, 48

# the zoo phase: (case, model, modality, task, frames per clip, attention
# and mel launches per clip forward)
ZOO_MODELS = (("vformer", "vformer", "V", "AU", FRAMES, 4, 0),
              ("sformer_au", "sformer", "V", "AU", 1, 3, 0),
              ("sformer_va", "sformer", "V", "VA", 1, 3, 0),
              ("tformer", "tformer", "V", "AU", FRAMES, 9, 0),
              ("dsformer", "dsformer", "V;M", "AU", 1, 2, 0),
              ("vggformer", "vggformer", "V", "AU", FRAMES, 4, 0),
              ("audio", "audio", "A", "AU", FRAMES, 2, 1),
              ("resnet", "resnet", "V", "AU", 1, 0, 0),
              ("van", "van", "V", "AU", 1, 2, 0),
              ("emonet", "emonet", "V", "AU", 1, 2, 0),
              ("i3d", "i3d", "V", "AU", FRAMES, 0, 0),
              ("mc3d", "mc3d", "V", "AU", FRAMES, 0, 0),
              ("tsav", "tsav", "A;V", "AU", FRAMES, 0, 1))
# emonet's full width: its hourglass needs a multiple of 64
ZOO_IMAGE = {"emonet": 256}
VFORMER_ATTN_PER_BUCKET = 4     # 1 spatial + 3 temporal
SFORMER_ATTN_PER_BUCKET = 3     # 1 spatial + 2 AU tokens
# van's and emonet's SingleFrameSweep: the AU head's 2 per bucket
SINGLE_FRAME_ATTN_PER_BUCKET = {"van": 2, "emonet": 2}
ZOO_BF16_REL = 5e-2       # card bf16 vs card fp32 logits, norm-relative
SINGLE_FRAME_ROWS = 64    # sformer's clip-path check: the first 64 frames

# the train phase's split: train, train, val, test; with downsample_rate 2
# that is 17 steps of 64 clips per epoch (TRACE_STEPS needs 16) and one val
# batch of 256
TRAIN_FRAMES = (1100, 1100, 600, 100)
TRAIN_BATCH = 64
# attention gradient sites: (name, tokens, head dim, batch) with 8 heads
GRAD_SITES = (("fusion_head", 12, 32, TRAIN_BATCH),
              ("spatial", 49, 32, TRAIN_BATCH * FRAMES),
              ("temporal", 17, 64, TRAIN_BATCH))
ATTN_FWD_PER_STEP, ATTN_BWD_PER_STEP = 11, 3
ATTN_HEAD_FWD_PER_STEP = 3              # of the 11: the fusion head's layers
STEP_TOL = (2e-3, 2e-4)   # rtol, atol: card fp32 step vs CPU fp32 step
STATS_TOL = (1e-3, 1e-4)  # BatchNorm running statistics after that step
OVERFIT_STEPS = 30
# vformer through train.main: 1 spatial + 3 temporal attention layers, all
# trained (forward launches, backward calls per step); its sites (tokens,
# head dim) for the per-site trace
VFORMER_SITES = {"spatial": (49, 32), "temporal": (17, 64)}
# the card-vs-CPU fp32 step of every non-avformer model: 64x64 (emonet's
# multiple of 64), T=2 (or 1), B=4, dropout 0. Each gradient is held
# within STEP_TOL's rtol of its norm, plus the atol per element, plus 3x
# the largest move of the CPU gradient when the weights move by 1e-6 of
# themselves (ZOO_STEP_MOVES seeded draws): a ReLU that flips within f32
# noise of 0 moves a small batch's first-layer gradient by ~1/sqrt(its
# output positions), so i3d's gradients move 1-2 % under such a draw, by
# 2.7-7.5 in norm (~360) for its stem (tests/test_torch_zoo_train.py)
ZOO_STEP = dict(image=64, frames=2, batch=4)
ZOO_STEP_MOVES = 3
# (model, modality) of every zoo model but avformer, once each
ZOO_STEP_MODELS = tuple(dict.fromkeys(
    (name, modality) for _, name, modality, *_ in ZOO_MODELS))
# attention per train step of each zoo model: every layer trains, so its
# forward launches (ZOO_MODELS) and as many backward calls
ZOO_TRAIN_ATTN = {name: attn for _, name, _, _, _, attn, _ in ZOO_MODELS}
VFORMER_ATTN_PER_STEP = (ZOO_TRAIN_ATTN["vformer"],) * 2
ZOO_TRAIN_STEPS = 3      # bf16 steps per model at full width, B=64
# the feed sub-phase: one epoch of train.main per feed; the dense and the
# frame-dedup + wav-arena runs shuffle runs of FEED_RUN indices, so both see
# the same batches
FEED_RUN = 64
FEED_LOSS_RTOL = 1e-5    # fp32 step: dense + raw windows vs dedup + arena
TRACE_STEPS = 16         # the --profile_dir run: its window is steps 10-15
# the graph sub-phase (--steps_per_dispatch K: a CUDA graph of the step):
# fp32 checks of GRAPH_STEPS steps as dispatches of GRAPH_K (the warm-up,
# then a capture and its replays) against eager steps, and the fed loop at
# FEED_GRAPH_K
GRAPH_K = 2
GRAPH_STEPS = 4
FEED_GRAPH_K = 4
# the host_aug sub-phase: the loader's threads of the first-batch check, the
# loader batches timed on the CPU, and the SHA-256 of the port's
# train_augment over transforms.digest_seeds()'s clips that PIL gives
# (tests/test_torch_host_augment.py computes it from PIL; this machine has
# no PIL)
HOST_AUG_THREADS = (1, 4)
HOST_AUG_BATCHES = 4
HOST_AUG_IN_THREAD_STEPS = 4
# the dp sub-phase: the NCCL world of one's fp32 step and graph checks
# (B=16), K, steps; the gloo world of two's global batch and timed steps;
# the two swept videos' frames; the draws' cost at 8 ranks of 8 rows
DP_STEP_BATCH, DP_GRAPH_K, DP_GRAPH_STEPS = 16, 4, 8
DP_GLOO_BATCH, DP_TIMED_STEPS, DP_SERVE_FRAMES = 16, 3, 300
DP_DRAW_WORLD = DP_DRAW_LOCAL = 8
DP_OVERHEAD_ROUNDS, DP_OVERHEAD_STEPS = 4, 4
# tests/test_parallel.py's tolerances: loss, gradients (rtol, atol), stats
DP_LOSS_REL, DP_GRAD_TOL, DP_STATS_ATOL = 1e-5, (5e-3, 5e-5), 1e-4
DP_TIMEOUT_S = 600
PIL_DIGEST = "ab03ee6ec397065e602c19f69374b3fa813e9743dc9fbcaedd7e47bdac851dd9"
# the ingest phase: the PNG-aligned split's frames; a decoded frame of the
# store against its PNG source (JPEG q95, 4:2:0 chroma of the noisy
# fixture frames: libjpeg gives a mean of 3.73 and a max of 26 levels), and
# jpeg_compression's clip (quality 80-98) against its source within the
# dataset phase's q90 bounds; the clips timed on the CPU
INGEST_FRAMES, INGEST_PAETH_FRAMES = 300, 100
INGEST_MEAN_TOL, INGEST_MAX_TOL = 5.0, 40
INGEST_CLIP_FRAMES = 16
INGEST_REPS = 5
# the orbax phase: the committed checkpoints and the JAX avformer's leaves
ORBAX_FIXTURES = ROOT / "tests" / "data" / "orbax"
# the decode phase: MJPEG frames through nvJPEG's planes and the yuv_rgb
# kernel; the fixtures and what the JAX package's cv2 read from them
DECODE_FIXTURES = ROOT / "tests" / "data" / "videos_decode"
DECODE_SIZE = (720, 1280)         # the full-width stream: 1280x720, 30 fps
DECODE_FRAMES = 300
DECODE_SEEKS = (0, 29, 150, 151, 299)
DECODE_PLAIN_RUNS = ((0, 30), (150, 180))   # also converted on the CPU
MJPG_MAX, MJPG_MEAN = 3, 0.1  # vs cv2: the two inverse DCTs round apart
DECODE_SOURCE_MAE = 3.0       # JPEG q90 error against the source frames
# the quickstart phase's attention gradient sites (name, tokens, head dim,
# batch)
QUICKSTART_GRAD_SITES = (("quickstart_spatial", 16, 32, QUICKSTART_BATCH * 4),
                         ("quickstart_temporal", 5, 64, QUICKSTART_BATCH))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def on_device(event) -> bool:
    return str(event.device_type).endswith("CUDA")


def recorded_device_time(prof) -> bool:
    return any(on_device(e) and e.device_time_total > 0
               for e in prof.key_averages())


def device_profile(torch, run, cpu: bool = False,
                   accept=recorded_device_time):
    """A torch.profiler session around ``run()`` that ``accept`` takes (by
    default: one that recorded device time), or None when
    PROFILER_SESSIONS sessions in a row were not taken. CUPTI on the card
    misses the device activity of a whole session now and then: the first
    of a process's, and rarely a later one."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                            else [])
    for _ in range(PROFILER_SESSIONS):
        PROFILER_LOG["sessions"] += 1
        with profile(activities=activities) as prof:
            run()
            torch.cuda.synchronize()
        if accept(prof):
            return prof
        PROFILER_LOG["sessions_without_device_time"] += 1
    return None


def timed(torch, fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """(device ms, event ms) per call of ``fn``. Device ms: the device time
    of everything one call launches, from torch.profiler (CUPTI); the event
    ms where no session recorded device time (counted in PROFILER_LOG).
    Event ms: CUDA events around ``iters`` back-to-back calls; where a
    call's kernels are shorter than its host-side launch cost, this is the
    host's rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / iters

    def calls():
        for _ in range(iters):
            fn()
    prof = device_profile(torch, calls)
    if prof is None:
        PROFILER_LOG["event_timed_cases"] += 1
        return event_ms, event_ms
    device_us = sum(e.device_time_total for e in prof.key_averages()
                    if on_device(e))
    return device_us / iters / 1e3, event_ms


def bound(nbytes: float, op_seconds: float) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak rate of their type, in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_bytes >= op_seconds:
        return t_bytes * 1e3, "bytes"
    return op_seconds * 1e3, "operations"


def random_reference_state_dict(model, seed: int) -> dict:
    """numpy weights for every key of the port's (= reference .pth)
    layout: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + noise, running
    variances in [1, 1.3), embeddings ~ N(0, 1), the rest ~ N(0, 0.01)."""
    rs = np.random.RandomState(seed)
    sd = {}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        shape = tuple(t.shape)
        name = key.rsplit(".", 1)[-1]
        if name == "running_var":
            v = 1.0 + 0.3 * rs.rand(*shape)
        elif name == "weight" and len(shape) == 1:
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "weight":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif name in ("pos_embedding", "cls_token"):
            v = rs.randn(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        sd[key] = v.astype(np.float32)
    return sd


def make_batch(rs, n: int) -> dict:
    """uint8 clips + right-aligned raw audio; every other clip carries a
    shorter left-zero-padded window with its feature_len."""
    clip = rs.randint(0, 256, (n, FRAMES, IMAGE, IMAGE, 3)).astype(np.uint8)
    audio = (rs.randn(n, 441000) * 0.1).astype(np.float32)
    n_valid = np.where(np.arange(n) % 2, rs.randint(441, 441000, n), 441000)
    audio[np.arange(441000)[None, :] < (441000 - n_valid)[:, None]] = 0.0
    return {"clip": clip, "audio": audio,
            "feature_len": (1 + n_valid // 441).astype(np.int32)}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_env(torch) -> str:
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


def phase_build() -> None:
    from auformer_torch.ops import build
    t0 = time.perf_counter()
    logs = build.build(build.KERNELS)
    for name in build.KERNELS:
        build.library(name)
    seconds = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    tensor_core = {n: build.tensor_core_instructions(n)
                   for n in build.KERNELS}
    if any(tensor_core[n] == 0 for n in TENSOR_CORE_KERNELS):
        fail(f"a kernel runs no tensor-core instruction: {tensor_core}")
    emit("build", seconds=round(seconds, 3),
         sources=[str(build.source(n).relative_to(ROOT))
                  for n in build.KERNELS], ptxas=ptxas,
         tensor_core_instructions=tensor_core)


def attention_cases(torch, dev) -> list[dict]:
    import torch.nn.functional as F
    from auformer_torch.ops.attention import (attention_reference,
                                              fused_attention)
    rs = np.random.RandomState(SEED + 1)
    cases = []
    for path, site, n, d, batch, per_call in ATTENTION_SITES:
        shape = (batch, HEADS, n, d)
        # the fused projection's output, (B, N, 3 * H * D), as
        # Attention.forward hands it over: strided (B, H, N, D) views
        qkv = rs.randn(shape[0], n, 3 * HEADS * d).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = torch.from_numpy(qkv).to(dev, dtype).reshape(
                shape[0], n, 3, HEADS, d).permute(2, 0, 3, 1, 4).unbind(0)
            scale = d ** -0.5
            got = fused_attention(q, k, v, scale)
            want = attention_reference(q, k, v, scale)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            rtol, atol = ATTN_TOL[dname]
            err = (got.float() - want.float()).abs().max().item()
            if not torch.allclose(got.float(), want.float(), rtol=rtol,
                                  atol=atol):
                fail(f"attention {path} {site} {dname}: max |err| {err}")
            nbytes = 4 * q.numel() * q.element_size()
            flops = 4 * q.shape[0] * HEADS * n * n * d
            peak = PEAK_FLOPS["f32" if dtype == torch.float32 else "bf16"]
            b_ms, b_by = bound(nbytes, flops / peak)
            ms, ev = timed(torch, lambda: fused_attention(q, k, v, scale), 50)
            plain, plain_ev = timed(
                torch, lambda: attention_reference(q, k, v, scale), 50)
            lib, lib_ev = timed(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), 50)
            cases.append(dict(
                path=path, site=site, dtype=dname, shape=list(shape),
                launches_per_call=per_call, max_abs_err=err,
                rtol=rtol, atol=atol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, event_ms=ev,
                plain_event_ms=plain_ev, library_event_ms=lib_ev))
    return cases


def mel_bound(b: int, valid_frames: int) -> tuple[float, str]:
    """Bytes: audio, output, feature_len, the kernel's basis and filterbank
    tables. Operations of each valid frame: the 882 x 1026 DFT (bf16
    operands), then in f32 the power of 513 bins and one multiply-add per
    nonzero weight of the triangular HTK filterbank."""
    from auformer_torch.ops.audio import mel_filterbank
    nbytes = (b * 441000 * 4 + b * 64 * 1001 * 4 + b * 4
              + 1024 * 912 * 2 + 64 * 512 * 4 + 64 * 8)
    dft = 2 * valid_frames * 882 * 1026
    mel = valid_frames * (3 * 513 + 2 * np.count_nonzero(mel_filterbank()))
    return bound(nbytes, dft / PEAK_FLOPS["bf16"] + mel / PEAK_FLOPS["f32"])


def mel_cases(torch, dev, batch: dict) -> list[dict]:
    from auformer_torch.ops.audio_kernel import (mel_frontend,
                                                 mel_frontend_reference)
    audio = torch.from_numpy(batch["audio"]).to(dev)
    cases = []
    for name, flen in (("full", None),
                       ("feature_len",
                        torch.from_numpy(batch["feature_len"]).to(dev))):
        got = mel_frontend(audio, flen)
        want = mel_frontend_reference(audio, flen)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not (got.shape == want.shape == (BATCH, 1, 64, 1001)
                and torch.isfinite(got).all() and err <= MEL_ATOL):
            fail(f"mel {name}: shape {tuple(got.shape)}, max |err| {err}")
        valid = (BATCH * 1001 if flen is None
                 else int(flen.clamp(max=1001).sum()))
        b_ms, b_by = mel_bound(BATCH, valid)
        ms, ev = timed(torch, lambda: mel_frontend(audio, flen), 20)
        plain, plain_ev = timed(
            torch, lambda: mel_frontend_reference(audio, flen), 10)
        cases.append(dict(
            case=name, shape=[BATCH, 441000], max_abs_err=err,
            atol=MEL_ATOL, launches_per_forward=1, ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=b_ms, bound_by=b_by, event_ms=ev,
            plain_event_ms=plain_ev))
    return cases


def clips_per_s(torch, infer, batch: dict, iters: int) -> float:
    for _ in range(3):
        infer(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        infer(batch)
    torch.cuda.synchronize()
    return BATCH * iters / (time.perf_counter() - t0)


def profile_forward(torch, infer, batch: dict) -> dict:
    """Device time by kernel over 3 forwards (torch.profiler); None where
    no session recorded device time."""
    infer(batch)
    torch.cuda.synchronize()

    def forwards():
        for _ in range(3):
            infer(batch)
    prof = device_profile(torch, forwards, cpu=True)
    if prof is None:
        return None
    events = [e for e in prof.key_averages()
              if on_device(e) and e.device_time_total > 0]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    total_us = sum(e.device_time_total for e in events)
    return {"device_ms_per_forward": total_us / 3e3,
            "device_kernels_per_forward": sum(e.count for e in events) / 3,
            "top": [{"name": e.key[:80],
                     "ms_per_forward": e.device_time_total / 3e3,
                     "calls_per_forward": e.count / 3}
                    for e in events[:12]]}


def check_submission(result_dir: str, want_rows: dict, out,
                     n_rows: int | None = None) -> None:
    """Each video's AU file: the header and one row of 12 binary labels per
    label frame (``want_rows``: video id -> rows); inference.pkl holds the
    returned (``n_rows``, 21) predictions, by default one row per label
    frame."""
    for vid, rows in want_rows.items():
        lines = Path(result_dir, "au", f"{vid}.txt").read_text().splitlines()
        if (lines[0] != "AU1,AU2,AU4,AU6,AU7,AU10,AU12,AU15,AU23,AU24,AU25,"
                        "AU26" or len(lines) != rows + 1
                or any(set(ln) - set("01,") or ln.count(",") != 11
                       for ln in lines[1:])):
            fail(f"submission file of {vid} is malformed")
    with open(Path(result_dir, "inference.pkl"), "rb") as f:
        preds = pickle.load(f)["predictions"]
    n = sum(want_rows.values()) if n_rows is None else n_rows
    if preds.shape != (n, 21) or not np.array_equal(preds, out):
        fail(f"inference.pkl holds {preds.shape}, expected ({n}, 21)")


def phase_slice(torch, dev, batch: dict):
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.infer import make_infer_fn, run_inference
    from auformer_torch.nn import build_model
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend

    cfg32 = Config(compute_dtype="float32", image_size=IMAGE,
                   n_frames=FRAMES, batch_size=BATCH)
    model32 = build_model(cfg32)
    sd = random_reference_state_dict(model32, SEED)
    load_weights(model32, sd)
    cpu_model = copy.deepcopy(model32)
    infer32 = make_infer_fn(cfg32, model32)
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    cfg16 = Config(image_size=IMAGE, n_frames=FRAMES, batch_size=BATCH)
    model16 = build_model(cfg16)
    load_weights(model16, sd)
    infer16 = make_infer_fn(cfg16, model16)

    def counted(infer):
        """One forward with the launch counts set to 0 just before it and
        read just after."""
        fused_attention.launches = 0
        mel_frontend.launches = 0
        out = infer(on_card)
        torch.cuda.synchronize()
        got = {"attention": fused_attention.launches,
               "mel": mel_frontend.launches}
        want = {"attention": ATTN_PER_CALL, "mel": 1}
        if got != want:
            fail(f"launches per forward {got}, expected {want}")
        return out, got

    # the main path: the default (bf16) configuration
    logits16, launches = counted(infer16)
    logits, launches32 = counted(infer32)

    t0 = time.perf_counter()
    cpu_logits = make_infer_fn(cfg32, cpu_model, device="cpu")(batch)
    cpu_s = time.perf_counter() - t0
    got = logits.cpu()
    err = (got - cpu_logits).abs().max().item()
    if got.shape != (BATCH, 21) or not torch.isfinite(got).all():
        fail(f"logits shape {tuple(got.shape)} or non-finite values")
    if not torch.allclose(got, cpu_logits, rtol=SLICE_TOL[0],
                          atol=SLICE_TOL[1]):
        fail(f"fp32 logits on the card differ from the CPU port by {err}")
    if got[:, 12:].abs().max().item() != 0.0:
        fail("EX/VA slices of the avformer output are not zero")

    if logits16.shape != (BATCH, 21) or not torch.isfinite(logits16).all():
        fail("bf16 logits are not finite")
    rate32 = clips_per_s(torch, infer32, on_card, 20)
    rate16 = clips_per_s(torch, infer16, on_card, 20)
    torch.cuda.reset_peak_memory_stats()
    prof = profile_forward(torch, infer16, on_card)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # the same forward with f32 convolution and Linear weights: autocast
    # casts each at every call
    model_casts = build_model(cfg16)
    load_weights(model_casts, sd)
    infer_casts = make_infer_fn(cfg16, model_casts)
    f32_weights(torch, model_casts)
    casts_diff = (infer_casts(on_card) - logits16).abs().max().item()
    prof_casts = profile_forward(torch, infer_casts, on_card)
    rate_casts = clips_per_s(torch, infer_casts, on_card, 20)
    del model_casts, infer_casts

    rs = np.random.RandomState(SEED + 2)
    batches = []
    for i, n in enumerate((BATCH, BATCH, 3)):
        b = make_batch(rs, n)
        start = i * BATCH
        b["Index"] = np.arange(start, start + n)
        b["video_id"] = np.array([f"video_{(start + j) // 10}"
                                  for j in range(n)])
        batches.append(b)
    with tempfile.TemporaryDirectory() as tmp:
        out = run_inference(cfg16, model16, batches, tmp)
        want_rows = {}
        for b in batches:
            for vid in b["video_id"]:
                want_rows[vid] = want_rows.get(vid, 0) + 1
        check_submission(tmp, want_rows, out)

    wall_ms = 1e3 * BATCH / rate16
    emit("slice", batch=BATCH, frames=FRAMES, image=IMAGE,
         launches_per_forward={"bfloat16": launches, "float32": launches32},
         max_abs_err_fp32_vs_cpu=err,
         rtol=SLICE_TOL[0], atol=SLICE_TOL[1], cpu_forward_s=cpu_s,
         max_abs_diff_bf16_vs_fp32=(logits16 - logits).abs().max().item(),
         clips_per_s={"float32": rate32, "bfloat16": rate16},
         wall_ms_per_forward_bf16=wall_ms,
         device_idle_share_bf16=(
             None if prof is None
             else 1.0 - prof["device_ms_per_forward"] / wall_ms),
         peak_memory_mb_bf16=peak_mb, profile_bf16=prof,
         per_call_casts_bf16={
             "max_abs_diff_vs_rounded_once": casts_diff,
             "clips_per_s": rate_casts,
             "device_ms_per_forward": (
                 None if prof_casts is None
                 else prof_casts["device_ms_per_forward"]),
             "device_kernels_per_forward": (
                 None if prof_casts is None
                 else prof_casts["device_kernels_per_forward"])},
         run_inference={"batches": len(batches),
                        "rows": int(out.shape[0])})
    return launches


def sweep_video(seed: int):
    """uint8 frames, a 70 s wav and ideal 30 fps timestamps: windows short
    at the start (ts < 10 s), full in the middle, truncated by the end of
    the file (ts > 65 s)."""
    rs = np.random.RandomState(seed)
    frames = rs.randint(0, 256, (SWEEP_FRAMES, IMAGE, IMAGE, 3),
                        dtype=np.uint8)
    wav = (rs.randn(SWEEP_WAV_SECS * 44100) * 0.1).astype(np.float32)
    return frames, wav, np.arange(SWEEP_FRAMES) * 1000.0 / 30.0


def f32_weights(torch, model) -> int:
    """Give every Conv2d and Linear weight of ``model`` back its f32 dtype
    (the values ``prepare_inference`` rounded to bf16), so that autocast
    casts each at every call; returns how many."""
    mods = [m for m in model.modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    for m in mods:
        m.weight.data = m.weight.data.float()
    return len(mods)


class BucketCounts:
    """Launch counts per bucket: wraps a sweep's ``method`` (called once
    per bucket: ``fused_sweep``, or ``fused_sweep_packed`` per packed
    bucket) and records the launches each call adds."""

    def __init__(self, sweep, fused_attention, mel_frontend,
                 method: str = "fused_sweep"):
        self.calls = []
        inner = getattr(sweep, method)

        def counted(*args, **kwargs):
            before = fused_attention.launches, mel_frontend.launches
            out = inner(*args, **kwargs)
            self.calls.append(
                {"attention": fused_attention.launches - before[0],
                 "mel": mel_frontend.launches - before[1]})
            return out
        setattr(sweep, method, counted)


def stage_profile(torch, sweep, run) -> dict:
    """Device ms of one ``run()`` by stage: record_function ranges around
    the sweep's methods, each range's device time the sum of the kernels
    launched inside it. Stages: the phase table (once per video), the
    phase-mel features (edge frames, gather, dB; a bucket minus its
    fused_sweep), the trunk, the audio resnet, and the heads (fused_sweep
    minus trunk and audio: T-Former, AU_formers, fusion, window gather).
    None where no session attributed device time to every measured
    range."""
    from torch.profiler import record_function
    names = {"fused_sweep_phase_audio": "bucket",
             "fused_sweep": "fused_sweep", "frame_features": "trunk",
             "phase_mel_table": "table", "a_net": "audio_resnet"}
    saved = {attr: getattr(sweep, attr) for attr in names}

    def ranged(label, fn):
        def call(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return call
    for attr, label in names.items():
        setattr(sweep, attr, ranged(f"sweep/{label}", saved[attr]))

    def range_ms(prof) -> dict:
        us = {label: 0.0 for label in names.values()}
        for e in prof.events():
            label = e.name[len("sweep/"):]
            if (e.name.startswith("sweep/") and label in us
                    and str(e.device_type).endswith("CPU")):
                us[label] += e.device_time_total
        return {k: v / 1e3 for k, v in us.items()}

    def attributed(prof) -> bool:
        ms = range_ms(prof)
        return min(ms["bucket"], ms["trunk"], ms["audio_resnet"]) > 0
    try:
        prof = device_profile(torch, run, cpu=True, accept=attributed)
    finally:
        for attr, fn in saved.items():
            if attr == "a_net":
                sweep.a_net = fn
            else:
                delattr(sweep, attr)
    if prof is None:
        return None
    ms = range_ms(prof)
    return {"phase_table": ms["table"],
            "phase_features": ms["bucket"] - ms["fused_sweep"],
            "trunk": ms["trunk"], "audio_resnet": ms["audio_resnet"],
            "heads": ms["fused_sweep"] - ms["trunk"] - ms["audio_resnet"]}


def phase_sweep(torch, dev) -> dict:
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.infer import make_infer_fn, run_inference_sweep
    from auformer_torch.nn import build_model
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend
    from auformer_torch.ops.phase_mel import (SLEN, phase_mel_table,
                                              phase_plan,
                                              phase_window_features)
    from auformer_torch.sweep import AvformerSweep, default_sweep_bucket

    frames, wav, ts = sweep_video(SEED + 3)
    n = SWEEP_FRAMES
    bucket = default_sweep_bucket(dev)
    cfg16 = Config(image_size=IMAGE, n_frames=FRAMES)
    cfg32 = Config(compute_dtype="float32", image_size=IMAGE,
                   n_frames=FRAMES)
    model16, model32 = build_model(cfg16), build_model(cfg32)
    sd = random_reference_state_dict(model32, SEED)
    load_weights(model16, sd)
    load_weights(model32, sd)
    sweep16 = AvformerSweep(cfg16, model16)
    sweep32 = AvformerSweep(cfg32, model32)
    bsize = sweep16._bucket_size(n, bucket)
    n_buckets = -(-n // bsize)
    if (cfg16.label_frame, bsize, n_buckets) != (LABEL_FRAME, SWEEP_BSIZE, 2):
        fail(f"the sweep splits {n} frames into {n_buckets} buckets of "
             f"{bsize}, not 2 of {SWEEP_BSIZE}")

    # the main path: run_inference_sweep (bf16) over the video and a
    # second, shorter one, with the counts set to 0 just before it
    m = SECOND_FRAMES
    items = [dict(video_id="video_a", Index=np.arange(n), frames=frames,
                  wav=wav, timestamps_ms=ts),
             dict(video_id="video_b", Index=np.arange(n, n + m),
                  frames=frames[:m], wav=wav[:20 * 44100],
                  timestamps_ms=ts[:m])]
    main_buckets = sum(-(-k // sweep16._bucket_size(k, bucket))
                       for k in (n, m))
    with tempfile.TemporaryDirectory() as tmp:
        fused_attention.launches = 0
        mel_frontend.launches = 0
        t0 = time.perf_counter()
        out = run_inference_sweep(cfg16, model16, items, tmp)
        ris_s = time.perf_counter() - t0
        launches = {"attention": fused_attention.launches,
                    "mel": mel_frontend.launches}
        want = {"attention": ATTN_PER_CALL * main_buckets, "mel": 0}
        if launches != want:
            fail(f"run_inference_sweep launched {launches}, expected {want}")
        check_submission(tmp, {"video_a": n, "video_b": m}, out)
    if not np.isfinite(out).all() or out[:, 12:].any():
        fail("run_inference_sweep predictions are not finite AU logits")

    # launches per bucket, and the bf16 logits
    counts = BucketCounts(sweep16, fused_attention, mel_frontend)
    logits16 = sweep16.sweep_video_device_audio(frames, wav, ts,
                                                batch=bucket)
    del sweep16.fused_sweep
    per_bucket = [{"attention": ATTN_PER_CALL, "mel": 0}] * n_buckets
    if counts.calls != per_bucket:
        fail(f"launches per bucket {counts.calls}, expected {per_bucket}")
    if logits16.shape != (n, 12) or not np.isfinite(logits16).all():
        fail("bf16 sweep logits are not finite")
    if not np.allclose(logits16, out[:n, :12], rtol=0, atol=0):
        fail("run_inference_sweep differs from sweep_video_device_audio")

    sel = np.array(FEATURE_WINDOWS)
    starts, n_valid = sweep32.audio_window_plan(ts, len(wav))
    phases, base, psel = phase_plan(starts.astype(np.int64) - SLEN, n_valid)
    ext = torch.zeros(len(wav) + 2 * SLEN + 512, device=dev)
    ext[SLEN:SLEN + len(wav)] = torch.from_numpy(wav).to(dev)
    picked = [torch.from_numpy(a[sel]).to(dev)
              for a in (starts, n_valid, base, psel)]
    feats = phase_window_features(ext, phase_mel_table(ext, np.unique(phases)),
                                  *picked)
    windows = sweep32.window_features(ext, picked[0], picked[1])
    feat_err = (feats - windows).abs().max().item()
    if feats.shape != (len(sel), 1, 64, 1001) or not feat_err <= FEATURE_ATOL:
        fail(f"phase-mel features differ from the per-window route by "
             f"{feat_err}")

    # fp32 sweep against the fp32 clip path on those 16 label frames
    logits32 = sweep32.sweep_video_device_audio(frames, wav, ts,
                                                batch=bucket)
    idx = sweep32.window_indices(n)[sel]                 # black slot = n
    clip = np.where((idx == n)[..., None, None, None], 0,
                    frames[np.minimum(idx, n - 1)])
    clip_logits = make_infer_fn(cfg32, model32)(
        {"clip": clip, "audio_features": feats})[:, :12].cpu().numpy()
    clip_err = float(np.abs(logits32[sel] - clip_logits).max())
    if not np.allclose(logits32[sel], clip_logits, rtol=SWEEP_TOL[0],
                       atol=SWEEP_TOL[1]):
        fail(f"fp32 sweep differs from the fp32 clip path by {clip_err}")

    # the per-window route, forced, against the phase route (256 frames)
    head = frames[:256], wav, ts[:256]
    phase256 = sweep32.sweep_video_device_audio(*head, batch=bucket)
    sweep32.max_phases = 0
    window256 = sweep32.sweep_video_device_audio(*head, batch=bucket)
    sweep32.max_phases = AvformerSweep.max_phases
    route_err = float(np.abs(window256 - phase256).max())
    if not np.allclose(window256, phase256, rtol=SWEEP_TOL[0],
                       atol=SWEEP_TOL[1]):
        fail(f"per-window route differs from the phase route by {route_err}")
    t0 = time.perf_counter()
    sweep32.sweep_video_device_audio(frames, wav, ts, batch=bucket)
    wall32_s = time.perf_counter() - t0
    del sweep32, model32, feats, windows, ext
    torch.cuda.empty_cache()

    # bf16 rate, device time and kernels, stages, memory
    def run():
        return sweep16.sweep_video_device_audio(frames, wav, ts, batch=bucket)
    run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall_s = float(np.median(walls))
    torch.cuda.reset_peak_memory_stats()
    prof = device_profile(torch, run, cpu=True)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    events = [] if prof is None else [
        e for e in prof.key_averages()
        if on_device(e) and e.device_time_total > 0]
    device_ms = (None if prof is None
                 else sum(e.device_time_total for e in events) / 1e3)
    kernels = sum(e.count for e in events)
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    stages = stage_profile(torch, sweep16, run)

    # prepare_inference rounded every convolution and Linear weight to bf16
    # once; with f32 weights autocast makes the same casts at every call:
    # the same logits, and the device time says what those casts cost
    precast = f32_weights(torch, model16)
    logits_pre = run()
    pre_rate, pre_walls = best_rate(torch, n, run)
    prof_pre = device_profile(torch, run, cpu=True)
    device_pre = (None if prof_pre is None else sum(
        e.device_time_total for e in prof_pre.key_averages()
        if on_device(e)) / 1e3)
    kernels_pre = (None if prof_pre is None else sum(
        e.count for e in prof_pre.key_averages()
        if on_device(e) and e.device_time_total > 0))

    result = dict(
        frames=n, image=IMAGE, t=FRAMES, dilation=cfg16.dilation,
        bucket_cap=bucket, buckets=[SWEEP_BSIZE, n - SWEEP_BSIZE],
        launches_per_bucket=counts.calls,
        feature_windows=list(FEATURE_WINDOWS),
        run_inference_sweep={"videos": 2, "rows": int(out.shape[0]),
                             "launches": launches, "seconds": ris_s},
        feature_max_abs_err=feat_err, feature_atol=FEATURE_ATOL,
        fp32_vs_clip_max_abs_err=clip_err,
        per_window_vs_phase_max_abs_err=route_err,
        rtol=SWEEP_TOL[0], atol=SWEEP_TOL[1],
        max_abs_diff_bf16_vs_fp32=float(np.abs(logits16 - logits32).max()),
        label_frames_per_s_bf16=n / wall_s,
        label_frames_per_s_fp32=n / wall32_s,
        wall_s_per_video_bf16=walls,
        device_ms_per_bucket_bf16=(None if prof is None
                                   else device_ms / n_buckets),
        device_idle_share_bf16=(None if prof is None
                                else 1.0 - device_ms / (1e3 * wall_s)),
        device_kernels_per_bucket_bf16=(None if prof is None
                                        else kernels / n_buckets),
        stage_device_ms_per_video_bf16=stages,
        peak_memory_mb_bf16=peak_mb,
        per_call_casts_bf16={
            "weights": precast,
            "max_abs_diff_vs_rounded_once": float(
                np.abs(logits_pre - logits16).max()),
            "device_ms_per_bucket": (None if device_pre is None
                                     else device_pre / n_buckets),
            "device_kernels_per_bucket": (None if kernels_pre is None
                                          else kernels_pre / n_buckets),
            "label_frames_per_s": pre_rate, "walls": pre_walls},
        top=[{"name": e.key[:80], "ms_per_video": e.device_time_total / 1e3,
              "calls_per_video": e.count} for e in events[:12]])
    emit("sweep", **result)
    return launches


def best_rate(torch, n: int, run, passes: int = 3) -> tuple[float, list]:
    """(best n / wall s over ``passes`` runs, the walls) with the host
    clock stopped after ``torch.cuda.synchronize()``."""
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return n / min(walls), walls


def phase_dataset(torch, dev) -> tuple[dict, dict, dict]:
    from auformer_torch import test_aff2
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.data import Aff2TestDataset, native
    from auformer_torch.data.fixtures import (fixture_frame,
                                              generate_synthetic_dataset)
    from auformer_torch.infer import run_inference, run_inference_sweep
    from auformer_torch.nn import build_model
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend
    from auformer_torch.serve import (DecodeWorker, decode_video_frames,
                                      read_video_wav, sweep_serve_benchmark)
    from auformer_torch.sweep import default_sweep_bucket, make_sweep

    t_phase = time.perf_counter()
    work = ROOT / ".cache" / "chip_smoke_dataset"
    shutil.rmtree(work, ignore_errors=True)
    root, labels, cache = (str(work / d) for d in ("root", "labels", "cache"))
    t0 = time.perf_counter()
    generate_synthetic_dataset(root, labels, n_videos=len(DATASET_FRAMES),
                               frames_per_video=DATASET_FRAMES,
                               image_size=IMAGE, seed=SEED,
                               with_masks=False, splits=["test"])
    fixture_s = time.perf_counter() - t0
    n = sum(DATASET_FRAMES)
    starts = np.cumsum((0,) + DATASET_FRAMES)
    videos = {f"vid{i:03d}": k for i, k in enumerate(DATASET_FRAMES)}

    cfg32 = Config(root=root, lmdb_label_dir=labels, cache_dir=cache,
                   image_size=IMAGE, n_frames=FRAMES, batch_size=BATCH,
                   compute_dtype="float32")
    model32 = build_model(cfg32)
    sd = random_reference_state_dict(model32, SEED)
    load_weights(model32, sd)
    pretrain = work / "experiments" / "avformer" / "pretrain"
    pretrain.mkdir(parents=True)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               pretrain / f"random_seed{SEED}.pth")

    # the main path: python -m auformer_torch.test_aff2 over the split, in
    # bf16 (the default), with the counts set to 0 just before it
    bucket = default_sweep_bucket(dev)
    sizer = make_sweep(cfg32, model32)
    main_buckets = sum(-(-k // sizer._bucket_size(k, bucket))
                       for k in DATASET_FRAMES)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        fused_attention.launches = 0
        mel_frontend.launches = 0
        t0 = time.perf_counter()
        out16 = test_aff2.main(["--root", root, "--lmdb_label_dir", labels,
                                "--cache_dir", cache,
                                "--image_size", str(IMAGE),
                                "--n_frames", str(FRAMES)])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {"attention": fused_attention.launches,
                    "mel": mel_frontend.launches}
    finally:
        os.chdir(cwd)
    want = {"attention": ATTN_PER_CALL * main_buckets, "mel": 0}
    if launches != want:
        fail(f"test_aff2.main launched {launches}, expected {want}")
    check_submission(str(work / "results"), videos, out16)
    if out16.shape != (n, 21) or not np.isfinite(out16).all() \
            or out16[:, 12:].any():
        fail(f"test_aff2.main predictions {out16.shape} are not finite AU "
             "logits")

    # fp32: the dataset-fed sweep against the array-fed one on the same
    # decoded frames, wavs and timestamps (the plumbing: Index, video_id,
    # order)
    ds = Aff2TestDataset(cfg32)
    out_ds = run_inference_sweep(cfg32, model32, dataset=ds,
                                 result_path=str(work / "fp32_dataset"))
    items = []
    for i, (vid, k) in enumerate(videos.items()):
        rows = np.arange(starts[i], starts[i] + k)
        items.append(dict(video_id=vid, Index=rows,
                          frames=decode_video_frames(ds, rows, IMAGE, IMAGE),
                          wav=read_video_wav(root, vid),
                          timestamps_ms=np.asarray(ds.time_stamps)[rows]))
    out_arr = run_inference_sweep(cfg32, model32, items,
                                  result_path=str(work / "fp32_arrays"))
    plumbing_err = float(np.abs(out_ds - out_arr).max())
    if out_ds.shape != out_arr.shape or not plumbing_err <= PLUMBING_ATOL:
        fail(f"dataset-fed sweep differs from the array-fed sweep by "
             f"{plumbing_err}")

    # decoded frames against the generator's source images
    sample = [(i, t) for i, k in enumerate(DATASET_FRAMES)
              for t in range(0, k, 50)]
    decoded = np.stack([items[i]["frames"][t] for i, t in sample])
    source = np.stack([fixture_frame(SEED, i, t, IMAGE) for i, t in sample])
    jpeg = np.abs(decoded.astype(np.int16) - source)
    jpeg_mean, jpeg_max = float(jpeg.mean()), int(jpeg.max())
    if not (jpeg_mean <= JPEG_MEAN_TOL and jpeg_max <= JPEG_MAX_TOL):
        fail(f"decoded frames are {jpeg_mean} (mean) / {jpeg_max} (max) "
             "levels from their sources")

    # dataset-fed run_inference (DataLoader, B=8, host features) against
    # the sweep on label frames with whole 10 s windows
    rows = np.array(CLIP_ROWS)
    ds_clip = Aff2TestDataset(cfg32)
    ds_clip.test_ids = np.zeros_like(ds_clip.test_ids)
    ds_clip.test_ids[rows] = 1
    out_clip = run_inference(cfg32, model32, dataset=ds_clip,
                             result_path=str(work / "fp32_clip"))
    clip_err = float(np.abs(out_clip[rows, :12] - out_ds[rows, :12]).max())
    if not np.allclose(out_clip[rows, :12], out_ds[rows, :12],
                       rtol=SWEEP_TOL[0], atol=SWEEP_TOL[1]):
        fail(f"dataset-fed run_inference differs from the sweep by "
             f"{clip_err}")

    # the strict_parity sweep (per-window host features) on the 700-frame
    # video
    cfg_strict = Config(**{**cfg32.asdict(), "strict_parity": True})
    ds_strict = Aff2TestDataset(cfg_strict)
    last = np.arange(starts[-2], starts[-1])
    ds_strict.test_ids = np.zeros_like(ds_strict.test_ids)
    ds_strict.test_ids[last] = 1
    t0 = time.perf_counter()
    out_strict = run_inference_sweep(cfg_strict, model32, dataset=ds_strict,
                                     result_path=str(work / "fp32_strict"))
    strict_s = time.perf_counter() - t0
    if not np.isfinite(out_strict[last]).all() \
            or not out_strict[last, :12].any():
        fail("the strict_parity sweep wrote no finite logits")
    strict_diff = float(np.abs(out_strict[last, :12]
                               - out_ds[last, :12]).max())
    if not np.allclose(out_strict[last, :12], out_ds[last, :12],
                       rtol=SWEEP_TOL[0], atol=SWEEP_TOL[1]):
        fail(f"the strict_parity sweep differs from the default sweep by "
             f"{strict_diff}")
    del model32, sizer
    torch.cuda.empty_cache()

    # bf16 rates: the reader alone, the end-to-end pipeline (best of 3
    # warm passes through one worker), the array-fed sweep on the same
    # videos
    cfg16 = Config(root=root, lmdb_label_dir=labels, cache_dir=cache,
                   image_size=IMAGE, n_frames=FRAMES)
    model16 = build_model(cfg16)
    load_weights(model16, sd)
    ds16 = Aff2TestDataset(cfg16)
    keys0 = [ds16._store_key(p) for p in ds16.image_path[:DATASET_FRAMES[0]]]
    reader_rate, reader_walls = best_rate(
        torch, len(keys0),
        lambda: ds16.native_image.decode_batch(keys0, IMAGE, IMAGE, 3))
    keys = ("clips", "seconds", "decode_seconds", "wait_seconds",
            "sweep_seconds", "clips_per_sec")
    worker = DecodeWorker(cfg16)
    try:
        # the worker alone, one video at a time with the card idle: its
        # decode clock against the wall from request to the parent's
        # unpickled result (the rest is the pipe transfer)
        alone = []
        for nr in np.unique(ds16.video_db_nr[ds16.test_ids > 0]):
            t0 = time.perf_counter()
            worker.request(nr)
            vid_idx, *_, dsec = worker.result()
            alone.append({"frames": len(vid_idx), "decode_s": dsec,
                          "wall_s": time.perf_counter() - t0})
        sweep16 = make_sweep(cfg16, model16)
        passes = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            res = sweep_serve_benchmark(cfg16, model16, dataset=ds16,
                                        bucket=bucket, sweep=sweep16,
                                        decode_worker=worker)
            passes.append({k: res[k] for k in keys})
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    finally:
        worker.close()
    # the same pipeline with the decode on a thread of this process
    thread_passes = [
        {k: v for k, v in sweep_serve_benchmark(
            cfg16, model16, dataset=ds16, bucket=bucket, sweep=sweep16,
            decode_worker=False).items() if k in keys} for _ in range(2)]
    if any(p["clips"] != n for p in passes + thread_passes):
        fail(f"sweep_serve_benchmark labelled {passes + thread_passes}, "
             f"not {n} frames")
    e2e = max(passes, key=lambda p: p["clips_per_sec"])
    e2e_thread = max(thread_passes, key=lambda p: p["clips_per_sec"])
    with tempfile.TemporaryDirectory() as tmp:
        array_rate, array_walls = best_rate(
            torch, n, lambda: run_inference_sweep(cfg16, model16, items, tmp,
                                                  bucket=bucket))

    emit("dataset", videos=list(DATASET_FRAMES), label_frames=n,
         image=IMAGE, t=FRAMES, dilation=cfg16.dilation, bucket_cap=bucket,
         decoder=native.decoder(), fixture_s=fixture_s,
         test_aff2_main={"seconds": main_s, "launches": launches,
                         "buckets": main_buckets,
                         "launches_per_bucket": {
                             k: v / main_buckets
                             for k, v in launches.items()}},
         plumbing_max_abs_err=plumbing_err, plumbing_atol=PLUMBING_ATOL,
         clip_rows=[CLIP_ROWS.start, CLIP_ROWS.stop],
         clip_vs_sweep_max_abs_err=clip_err, rtol=SWEEP_TOL[0],
         atol=SWEEP_TOL[1], strict_frames=len(last), strict_s=strict_s,
         strict_vs_default_max_abs_diff=strict_diff,
         jpeg_frames=len(sample), jpeg_mean_abs=jpeg_mean,
         jpeg_max_abs=jpeg_max, jpeg_tol=[JPEG_MEAN_TOL, JPEG_MAX_TOL],
         reader_frames_per_s=reader_rate, reader_walls=reader_walls,
         reader_threads=cfg16.host_threads,
         worker_startup_s=worker.startup_seconds, worker_alone=alone,
         e2e_passes=passes, e2e_thread_passes=thread_passes,
         e2e_label_frames_per_s_bf16=e2e["clips_per_sec"],
         e2e_thread_label_frames_per_s_bf16=e2e_thread["clips_per_sec"],
         array_fed_label_frames_per_s_bf16=array_rate,
         array_fed_walls=array_walls,
         e2e_over_array_fed=e2e["clips_per_sec"] / array_rate,
         peak_memory_mb_bf16=peak_mb,
         phase_s=time.perf_counter() - t_phase)
    packed_launches = phase_packed(
        torch, dev, work, cfg32, cfg16, sd, videos,
        {"worker": e2e["clips_per_sec"],
         "thread": e2e_thread["clips_per_sec"], "array_fed": array_rate})
    split = dict(work=work, root=root, lmdb_label_dir=labels,
                 cache_dir=cache, videos=videos)
    return launches, packed_launches, split


def same_stream(got: list, want: list, what: str) -> float:
    """Two streams yield the same videos in the same order with the same
    rows; fp32 logits within SWEEP_TOL. Returns the max |difference|."""
    if [v for _, v, _ in got] != [v for _, v, _ in want]:
        fail(f"{what}: videos {[v for _, v, _ in got]}, expected "
             f"{[v for _, v, _ in want]}")
    err = 0.0
    for (gi, vid, gl), (wi, _, wl) in zip(got, want):
        if not np.array_equal(gi, wi) or gl.shape != (len(wi), 12) \
                or not np.isfinite(gl).all():
            fail(f"{what}: rows or logits of {vid} malformed")
        err = max(err, float(np.abs(gl - wl).max()))
        if not np.allclose(gl, wl, rtol=SWEEP_TOL[0], atol=SWEEP_TOL[1]):
            fail(f"{what}: {vid} differs from the per-video stream by {err}")
    return err


def phase_packed(torch, dev, work: Path, cfg32, cfg16, sd, videos: dict,
                 per_video_rates: dict) -> dict:
    """The packed cross-video route on the dataset phase's split: fp32
    packed = per-video through the decode worker's registered ring and
    through a thread, one video on the per-video fallback route; launches
    per packed bucket; the ring, its releases and chunk copies; bf16
    label frames/s of sweep_serve_benchmark(packed=True) through the worker
    (the main path, counts set to 0 just before its first pass) and a
    thread; then the submission's postprocess over test_aff2.main's
    files."""
    from auformer_torch import postprocess
    from auformer_torch.core.weights import load_weights
    from auformer_torch.data import Aff2TestDataset
    from auformer_torch.nn import build_model
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend
    from auformer_torch.packed import packed_sweep_stream
    from auformer_torch.serve import (DecodeWorker, sweep_serve_benchmark,
                                      sweep_stream)
    from auformer_torch.sweep import default_sweep_bucket, make_sweep

    t_phase = time.perf_counter()
    bucket = default_sweep_bucket(dev)
    n = sum(videos.values())
    model32 = build_model(cfg32)
    load_weights(model32, sd)
    sweep32 = make_sweep(cfg32, model32)
    ds = Aff2TestDataset(cfg32)
    ref = list(sweep_stream(cfg32, model32, dataset=ds, bucket=bucket,
                            sweep=sweep32, decode_worker=False))
    counts = BucketCounts(sweep32, fused_attention, mel_frontend,
                          "fused_sweep_packed")
    runs = {}
    worker = DecodeWorker(cfg32)
    try:
        for route, decoder in (("worker", worker), ("thread", False)):
            stats = {}
            got = list(packed_sweep_stream(cfg32, model32, dataset=ds,
                                           bucket=bucket, sweep=sweep32,
                                           decode_worker=decoder,
                                           stats=stats))
            runs[route] = {"max_abs_err": same_stream(
                got, ref, f"fp32 packed ({route})"),
                **{k: stats[k] for k in (
                    "buckets", "rows_dispatched", "rows_padded", "arena",
                    "releases", "chunk_copy_bytes", "fallback_videos")}}
            if not stats["arena"]["registered"] or \
                    stats["releases"]["made"] != stats["buckets"]:
                fail(f"packed ({route}): ring {stats['arena']}, releases "
                     f"{stats['releases']} for {stats['buckets']} buckets")
    finally:
        worker.close()
    per_bucket = [{"attention": ATTN_PER_CALL, "mel": 0}] * len(counts.calls)
    if not counts.calls or counts.calls != per_bucket:
        fail(f"launches per packed bucket {counts.calls}")

    # one video (the second, 1,200 frames) with jittered timestamps past
    # 5 s: more hop-grid phases than max_phases, the per-video route
    ds_fb = Aff2TestDataset(cfg32)
    ts = np.asarray(ds_fb.time_stamps, np.float64).copy()
    rows = np.nonzero(np.asarray(ds_fb.video_db_nr) == sorted(
        set(np.asarray(ds_fb.video_db_nr)))[1])[0]
    rs = np.random.RandomState(SEED + 10)
    late = rows[ts[rows] > 5000.0]
    ts[late] += rs.uniform(0.0, 9.9, len(late))
    ds_fb.time_stamps = ts
    ref_fb = list(sweep_stream(cfg32, model32, dataset=ds_fb, bucket=bucket,
                               sweep=sweep32, decode_worker=False))
    stats_fb = {}
    got_fb = list(packed_sweep_stream(cfg32, model32, dataset=ds_fb,
                                      bucket=bucket, sweep=sweep32,
                                      decode_worker=False, stats=stats_fb))
    fb_err = same_stream(got_fb, ref_fb, "fp32 packed with a fallback video")
    if stats_fb["fallback_videos"] != 1:
        fail(f"{stats_fb['fallback_videos']} videos took the fallback route")
    del model32, sweep32, ref, ref_fb, got_fb
    torch.cuda.empty_cache()

    # bf16 rates through sweep_serve_benchmark(packed=True)
    model16 = build_model(cfg16)
    load_weights(model16, sd)
    sweep16 = make_sweep(cfg16, model16)
    ds16 = Aff2TestDataset(cfg16)
    keys = ("clips", "seconds", "decode_seconds", "wait_seconds",
            "sweep_seconds", "clips_per_sec")
    stat_keys = ("buckets", "rows_dispatched", "rows_padded",
                 "chunk_copy_bytes", "releases", "arena")
    worker = DecodeWorker(cfg16)
    passes, thread_passes = [], []
    try:
        torch.cuda.reset_peak_memory_stats()
        for i in range(3):
            if i == 0:
                fused_attention.launches = 0
                mel_frontend.launches = 0
            res = sweep_serve_benchmark(cfg16, model16, dataset=ds16,
                                        bucket=bucket, sweep=sweep16,
                                        decode_worker=worker, packed=True)
            if i == 0:
                torch.cuda.synchronize()
                launches = {"attention": fused_attention.launches,
                            "mel": mel_frontend.launches}
                main_buckets = res["stats"]["buckets"]
            passes.append({**{k: res[k] for k in keys},
                           **{k: res["stats"][k] for k in stat_keys}})
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    finally:
        worker.close()
    for _ in range(3):
        res = sweep_serve_benchmark(cfg16, model16, dataset=ds16,
                                    bucket=bucket, sweep=sweep16,
                                    decode_worker=False, packed=True)
        thread_passes.append({k: res[k] for k in keys})
    # the warm-up sweep before each pass launches 11 per bucket too
    warm = -(-videos["vid000"] // sweep16._bucket_size(videos["vid000"],
                                                       bucket))
    want = {"attention": ATTN_PER_CALL * (main_buckets + warm), "mel": 0}
    if launches != want:
        fail(f"sweep_serve_benchmark(packed=True) launched {launches}, "
             f"expected {want}")
    if any(p["clips"] != n for p in passes + thread_passes):
        fail(f"packed passes labelled {[p['clips'] for p in passes]}")
    best = max(passes, key=lambda p: p["clips_per_sec"])
    best_thread = max(thread_passes, key=lambda p: p["clips_per_sec"])

    # the submission's postprocess: test_aff2.main's sparse files expanded
    # to each video's frame count (its meta.json side file: 25 frames more
    # than were detected), no video decoder
    aligned, video_dir = work / "aligned", work / "videos"
    video_dir.mkdir()
    for path in ds16.image_path:
        (aligned / os.path.dirname(path)).mkdir(parents=True, exist_ok=True)
        (aligned / path).touch()
    for vid, k in videos.items():
        (video_dir / f"{vid}.mp4").touch()
        (video_dir / f"{vid}.mp4meta.json").write_text(
            json.dumps({"num_frames": k + 25, "fps": 30.0}))
    t0 = time.perf_counter()
    postprocess.main(["--predictions", str(work / "results"),
                      "--frames_root", str(aligned), "--video_dir",
                      str(video_dir), "--out_dir", str(work / "dense"),
                      "--tasks", "au"])
    post_s = time.perf_counter() - t0
    for vid, k in videos.items():
        lines = Path(work, "dense", "au", f"{vid}.txt").read_text(
            ).splitlines()
        if len(lines) != k + 26 or not lines[0].startswith("AU1,AU2"):
            fail(f"postprocess wrote {len(lines)} lines for {vid}, "
                 f"expected {k + 26}")

    emit("packed", videos=list(videos.values()), label_frames=n,
         bucket_cap=bucket, fp32=runs, launches_per_packed_bucket=counts.calls,
         fallback={"videos": stats_fb["fallback_videos"],
                   "max_abs_err": fb_err,
                   "rows_padded": stats_fb["rows_padded"],
                   "arena_frames": stats_fb["arena"]["frames"]},
         rtol=SWEEP_TOL[0], atol=SWEEP_TOL[1],
         main={"launches": launches, "packed_buckets": main_buckets,
               "warmup_buckets": warm},
         e2e_passes=passes, e2e_thread_passes=thread_passes,
         e2e_label_frames_per_s_bf16=best["clips_per_sec"],
         e2e_thread_label_frames_per_s_bf16=best_thread["clips_per_sec"],
         per_video_label_frames_per_s_bf16=per_video_rates,
         rows_padded_share=best["rows_padded"] / best["rows_dispatched"],
         peak_memory_mb_bf16=peak_mb,
         postprocess={"videos": len(videos), "seconds": post_s,
                      "frames_per_video": [k + 25 for k in videos.values()]},
         phase_s=time.perf_counter() - t_phase)
    return launches


def zoo_batch(rs, name: str, modality: str, t: int,
              image: int = IMAGE) -> dict:
    """B=8 inputs of a zoo model: uint8 clips of its frames, channels (4
    for dsformer's RGB + mask) and width, and raw right-aligned audio with
    its feature lengths (``make_batch``'s) for the models that take audio
    (audio, tsav)."""
    batch = {}
    if name in ("audio", "tsav"):
        audio = make_batch(rs, BATCH)
        batch.update(audio=audio["audio"], feature_len=audio["feature_len"])
    if name != "audio":
        channels = 4 if modality == "V;M" else 3
        batch["clip"] = rs.randint(0, 256, (BATCH, t, image, image, channels),
                                   dtype=np.uint8)
    return batch


def profile_calls(torch, run, calls: int) -> dict | None:
    """Device ms and kernels per call over one ``run()`` of ``calls``
    calls (torch.profiler); None where no session recorded device time."""
    prof = device_profile(torch, run)
    if prof is None:
        return None
    events = [e for e in prof.key_averages()
              if on_device(e) and e.device_time_total > 0]
    return {"device_ms": sum(e.device_time_total for e in events)
            / 1e3 / calls,
            "kernels": sum(e.count for e in events) / calls}


def ingest_store(work: Path, root: str, labels: str, seed: int) -> dict:
    """(a) before the main path: the PNG-aligned frames of the split's one
    video, packed by create_image_store(reencode_png=True) (the native
    encoder: nvJPEG on this machine) into the split's image store under
    their ``.png`` keys, which the native reader takes the split's
    ``.jpg`` names to; decoded frames against their sources; PNG decode
    and JPEG encode frames/s on their own; PNG decode and
    create_image_store frames/s again on frames whose rows are all Paeth,
    read_png's slowest filter."""
    from auformer_torch.data import FrameStore, ingest, native
    from auformer_torch.data.dataset import STORE_IMAGES
    from auformer_torch.data.fixtures import fixture_frame, write_png
    from auformer_torch.data.png import read_png
    tree = work / "aligned_png"
    (tree / "vid000").mkdir(parents=True)
    sources = [fixture_frame(seed, 0, t, IMAGE) for t in range(INGEST_FRAMES)]
    paths = [str(tree / "vid000" / f"{t + 1:05d}.png")
             for t in range(INGEST_FRAMES)]
    t0 = time.perf_counter()
    for path, img in zip(paths, sources):
        write_png(path, img)
    write_s = time.perf_counter() - t0
    store = os.path.join(labels, STORE_IMAGES)
    shutil.rmtree(store)
    t0 = time.perf_counter()
    keys = ingest.create_image_store(str(tree), store)
    store_s = time.perf_counter() - t0
    want = [f"vid000/{t + 1:05d}.png" for t in range(INGEST_FRAMES)]
    if keys != want:
        fail(f"create_image_store gave keys {keys[:3]}..., expected "
             f"{want[:3]}...")
    packed = FrameStore(store)
    decoded, ok = native.NativeFrameStore(store).decode_batch(
        [key[:-4] + ".jpg" for key in keys], IMAGE, IMAGE)
    err = np.abs(decoded.astype(np.int16) - np.stack(sources))
    err_mean, err_max = float(err.mean()), int(err.max())
    if not (ok.all() and err_mean <= INGEST_MEAN_TOL
            and err_max <= INGEST_MAX_TOL):
        fail(f"the re-encoded store decodes {int(ok.sum())} of {len(ok)} "
             f"frames, {err_mean} (mean) / {err_max} (max) levels from "
             "their PNG sources")
    t0 = time.perf_counter()
    frames = [read_png(path) for path in paths]
    png_s = time.perf_counter() - t0
    if not all(np.array_equal(f, src) for f, src in zip(frames, sources)):
        fail("read_png does not give back the frames write_png wrote")
    t0 = time.perf_counter()
    for f in frames:
        native.encode_jpeg(f, 95)
    encode_s = time.perf_counter() - t0
    paeth = work / "aligned_paeth"
    (paeth / "vid000").mkdir(parents=True)
    paeth_paths = [str(paeth / "vid000" / f"{t + 1:05d}.png")
                   for t in range(INGEST_PAETH_FRAMES)]
    for path, img in zip(paeth_paths, sources):
        write_png(path, img, filters=(4,))
    t0 = time.perf_counter()
    frames = [read_png(path) for path in paeth_paths]
    paeth_png_s = time.perf_counter() - t0
    if not all(np.array_equal(f, src) for f, src in zip(frames, sources)):
        fail("read_png does not give back the all-Paeth frames")
    t0 = time.perf_counter()
    ingest.create_image_store(str(paeth), str(work / "paeth_store"))
    paeth_store_s = time.perf_counter() - t0
    return {"frames": INGEST_FRAMES, "encoder": native.decoder(),
            "png_write_frames_per_s": INGEST_FRAMES / write_s,
            "create_image_store_frames_per_s": INGEST_FRAMES / store_s,
            "png_decode_frames_per_s": INGEST_FRAMES / png_s,
            "jpeg_encode_frames_per_s": INGEST_FRAMES / encode_s,
            "all_paeth": {
                "frames": INGEST_PAETH_FRAMES,
                "png_decode_frames_per_s": INGEST_PAETH_FRAMES / paeth_png_s,
                "create_image_store_frames_per_s":
                    INGEST_PAETH_FRAMES / paeth_store_s},
            "store_bytes": sum(len(packed.get(k)) for k in keys),
            "png_bytes": sum(os.path.getsize(p) for p in paths),
            "decoded_vs_png": {"mean": err_mean, "max": err_max,
                               "mean_tol": INGEST_MEAN_TOL,
                               "max_tol": INGEST_MAX_TOL}}


def ingest_transforms(seed: int) -> dict:
    """(b) jpeg_compression through the native codec (nvJPEG here) and (c)
    the colour surface and the HSV tables, on this machine's CPU."""
    from auformer_torch.data import transforms
    from auformer_torch.data.fixtures import fixture_frame
    clip = np.stack([fixture_frame(seed, 1, t, IMAGE)
                     for t in range(INGEST_CLIP_FRAMES)])
    mask = ((clip[..., :1] > 100) * 255).astype(np.uint8)
    clip4 = np.concatenate([clip, mask], -1)
    out = transforms.jpeg_compression(clip4.copy(), 1.1,
                                      np.random.RandomState(seed))
    err = np.abs(out[..., :3].astype(np.int16) - clip)
    jc_mean, jc_max = float(err.mean()), int(err.max())
    if not (np.array_equal(out[..., 3], clip4[..., 3])
            and 0 < jc_mean <= JPEG_MEAN_TOL and jc_max <= JPEG_MAX_TOL):
        fail(f"jpeg_compression: mask unchanged "
             f"{np.array_equal(out[..., 3], clip4[..., 3])}, {jc_mean} "
             f"(mean) / {jc_max} (max) levels from the source")

    def ms_per_clip(fn) -> list:
        times = []
        for rep in range(INGEST_REPS):
            work = clip4.copy()
            t0 = time.perf_counter()
            fn(work, rep)
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    jc_ms = ms_per_clip(lambda c, r: transforms.jpeg_compression(
        c, 1.1, np.random.RandomState(r)))
    rca_ms = ms_per_clip(lambda c, r: transforms.random_color_augment(
        c[..., :3], rng=random.Random(r)))

    def colour_class(c, r):
        op = transforms.RandomColorAugment(0.3, 0.3, 0.1, 0.3,
                                           rng=random.Random(r))
        for t in range(len(c)):
            c[t, ..., :3] = op(c[t, ..., :3])
    rca_class_ms = ms_per_clip(colour_class)
    t0 = time.perf_counter()
    digests = transforms.hsv_digests()
    hsv_s = time.perf_counter() - t0
    if digests != transforms.PIL_HSV_DIGESTS:
        fail(f"the HSV tables hash to {digests}, PIL's to "
             f"{transforms.PIL_HSV_DIGESTS}")
    return {"jpeg_compression": {
                "clip": list(clip4.shape), "mask_unchanged": True,
                "vs_source": {"mean": jc_mean, "max": jc_max,
                              "mean_tol": JPEG_MEAN_TOL,
                              "max_tol": JPEG_MAX_TOL},
                "ms_per_clip": jc_ms},
            "random_color_augment_ms_per_clip": rca_ms,
            "RandomColorAugment_ms_per_clip": rca_class_ms,
            "hsv_tables": {"digests_equal_pil": True, "seconds": hsv_s}}


def ingest_videos(work: Path) -> dict:
    """(d) the decoder-free video index over tests/data/videos/ against
    what the JAX package read there (expected.json), then postprocess.main
    over copies of three of them without meta.json files."""
    from auformer_torch import postprocess
    from auformer_torch.data import ingest
    from auformer_torch.data.video import Video
    videos = ROOT / "tests" / "data" / "videos"
    expected = json.loads((videos / "expected.json").read_text())
    vdir = work / "videos"
    vdir.mkdir()
    t0 = time.perf_counter()
    for name, want in expected.items():
        path = str(vdir / name)
        shutil.copy(videos / name, path)
        v = Video(path, write=False)
        text = Path(ingest.extract_timestamps(
            path, str(work / "ts.txt"))).read_text()
        got = (v.meta, v.count_frames(), text, ingest.probe_video_meta(path))
        if got != (want["meta"], want["count_frames"], want["timestamps"],
                   want["meta"]):
            fail(f"{name}: the port reads {got[:3]}, the JAX package "
                 f"{want['meta']}, {want['count_frames']}")
    counts = postprocess.video_frame_counts(str(vdir))
    want_counts = {os.path.splitext(n)[0]: e["meta"]["num_frames"]
                   for n, e in expected.items()}
    if counts != want_counts:
        fail(f"video_frame_counts {counts}, expected {want_counts}")
    index_s = time.perf_counter() - t0
    bare = work / "bare_videos"
    bare.mkdir()
    detected = {"mp4v_30": (1, 2, 5), "xvid_25": (3, 4, 9)}
    for name in detected:
        ext = "mp4" if name.startswith("mp4") else "avi"
        shutil.copy(videos / f"{name}.{ext}", bare / f"{name}.{ext}")
        (work / "pred" / "AU").mkdir(parents=True, exist_ok=True)
        (work / "pred" / "AU" / f"{name}.txt").write_text("\n".join(
            ["h"] + [f"row{i}" for i in detected[name]]) + "\n")
        (work / "aligned" / name).mkdir(parents=True)
        for i in detected[name]:
            (work / "aligned" / name / f"{i:05d}.jpg").touch()
    postprocess.main(["--predictions", str(work / "pred"), "--frames_root",
                      str(work / "aligned"), "--video_dir", str(bare),
                      "--out_dir", str(work / "dense"), "--tasks", "AU"])
    dense = {name: Path(work / "dense" / "AU" / f"{name}.txt").read_text()
             .splitlines() for name in detected}
    metas = sorted(p.name for p in bare.glob("*meta.json"))
    if ([len(rows) for rows in dense.values()] != [13, 13]
            or metas != ["mp4v_30meta.json", "xvid_25meta.json"]):
        fail(f"postprocess.main without meta.json: rows "
             f"{[len(r) for r in dense.values()]}, side files {metas}")
    return {"videos": len(expected), "equal_expected": True,
            "index_s": index_s, "postprocess_rows": {
                name: len(rows) - 1 for name, rows in dense.items()},
            "side_files_written": metas}


def phase_ingest(torch, dev, pth: Path) -> dict:
    """The ingest phase (module docstring): (a) the PNG-aligned split's
    store, then the main path test_aff2.main over it in bf16 with the
    counts set to 0 just before it, (b) and (c) the host transforms, (d)
    the video index. ``pth``: the dataset phase's seeded weights."""
    from auformer_torch import test_aff2
    from auformer_torch.core.config import Config
    from auformer_torch.data.fixtures import generate_synthetic_dataset
    from auformer_torch.nn import build_model
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend
    from auformer_torch.sweep import default_sweep_bucket, make_sweep

    t_phase = time.perf_counter()
    work = ROOT / ".cache" / "chip_smoke_ingest"
    shutil.rmtree(work, ignore_errors=True)
    root, labels, cache = (str(work / d) for d in ("root", "labels", "cache"))
    seed = SEED + 13
    generate_synthetic_dataset(root, labels, n_videos=1,
                               frames_per_video=INGEST_FRAMES,
                               image_size=IMAGE, seed=seed, with_masks=False,
                               splits=["test"])
    store = ingest_store(work, root, labels, seed)

    pretrain = work / "experiments" / "avformer" / "pretrain"
    pretrain.mkdir(parents=True)
    os.symlink(pth, pretrain / pth.name)
    cfg = Config(root=root, lmdb_label_dir=labels, cache_dir=cache,
                 image_size=IMAGE, n_frames=FRAMES, batch_size=BATCH)
    sizer = make_sweep(cfg, build_model(cfg))
    buckets = -(-INGEST_FRAMES // sizer._bucket_size(
        INGEST_FRAMES, default_sweep_bucket(dev)))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        fused_attention.launches = 0
        mel_frontend.launches = 0
        t0 = time.perf_counter()
        out = test_aff2.main(["--root", root, "--lmdb_label_dir", labels,
                              "--cache_dir", cache, "--image_size",
                              str(IMAGE), "--n_frames", str(FRAMES)])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {"attention": fused_attention.launches,
                    "mel": mel_frontend.launches}
    finally:
        os.chdir(cwd)
    want = {"attention": ATTN_PER_CALL * buckets, "mel": 0}
    if launches != want:
        fail(f"test_aff2.main over the re-encoded store launched "
             f"{launches}, expected {want}")
    check_submission(str(work / "results"), {"vid000": INGEST_FRAMES}, out)
    if out.shape != (INGEST_FRAMES, 21) or not np.isfinite(out).all():
        fail(f"test_aff2.main over the re-encoded store: {out.shape}")
    store["test_aff2"] = {"seconds": main_s, "buckets": buckets,
                          "launches": launches}
    emit("ingest", nvidia_smi=nvidia_smi(), png_store=store,
         **ingest_transforms(seed), video_index=ingest_videos(work),
         phase_s=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)
    return launches


def _leaf_sha256(value, dtype: str) -> str:
    """SHA-256 of a restored leaf's C-order bytes (bfloat16 as its bits,
    a Python number as the zarr dtype)."""
    import hashlib

    import torch
    if isinstance(value, torch.Tensor):
        value = value.view(torch.int16).numpy()
    else:
        value = np.asarray(value, dtype=np.dtype(dtype))
    return hashlib.sha256(value.tobytes()).hexdigest()


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


def libzstd_check(frames: list) -> dict | None:
    """The fixtures' zstd frames through this machine's libzstd.so.1
    against the port's decoder (a cross-check, never the decoder); None
    where there is no libzstd."""
    import ctypes
    import ctypes.util

    from auformer_torch.data import native
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    for frame in frames:
        want = native.zstd_decompress(frame)
        buf = ctypes.create_string_buffer(len(want) + 1)
        n = lib.ZSTD_decompress(buf, len(buf), frame, len(frame))
        if lib.ZSTD_isError(n) or buf.raw[:n] != want:
            fail(f"libzstd ({name}) and the port's decoder disagree on a "
                 f"{len(frame)}-byte frame of the fixtures")
    return {"library": name, "version": lib.ZSTD_versionNumber(),
            "frames": len(frames), "equal": True}


def orbax_fixtures() -> dict:
    """(a): the decoder built here, the committed checkpoints read and
    held to expected.json."""
    from auformer_torch.core.orbax_reader import read_orbax_checkpoint
    from auformer_torch.data import native

    t0 = time.perf_counter()
    native.build("zstd")
    build_s = time.perf_counter() - t0
    with open(ORBAX_FIXTURES / "expected.json") as f:
        expected = json.load(f)
    leaves = {}
    for name, want in expected.items():
        got = _flat(read_orbax_checkpoint(str(ORBAX_FIXTURES / name)))
        if set(got) != set(want):
            fail(f"orbax fixture {name}: leaves {sorted(got)} against "
                 f"{sorted(want)}")
        for key, spec in want.items():
            if (list(np.shape(got[key])) != spec["shape"] or _leaf_sha256(
                    got[key], spec["dtype"]) != spec["sha256"]):
                fail(f"orbax fixture {name}: {key} differs from "
                     "expected.json")
        leaves[name] = len(want)
    frames = [p.read_bytes() for p in sorted((ORBAX_FIXTURES / "zarr").rglob(
        "*")) if p.is_file() and p.read_bytes()[:4] == b"\x28\xb5\x2f\xfd"]
    return {"build_s": build_s, "leaves_sha256_equal": leaves,
            "libzstd": libzstd_check(frames)}


def seeded_jax_tree(seed: int) -> dict:
    """The JAX avformer's {"params", "batch_stats"} at full width
    (avformer_tree.json) filled from ``seed``: kernels ~ N(0, 1/fan_in),
    norm scales ~ 1 + noise, variances in [1, 1.3), embeddings ~ N(0, 1),
    the rest ~ N(0, 0.01)."""
    with open(ORBAX_FIXTURES / "avformer_tree.json") as f:
        spec = json.load(f)
    rs = np.random.RandomState(seed)
    tree: dict = {}
    for leaf in spec:
        *parents, name = leaf["path"]
        shape = tuple(leaf["shape"])
        if name == "var":
            v = 1.0 + 0.3 * rs.rand(*shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("pos_embedding", "cls_token"):
            v = rs.randn(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = v.astype(np.float32)
    return tree


def phase_orbax(torch, dev, split: dict) -> dict:
    """The orbax phase (module docstring): (a) the fixtures, (b) a
    full-width JAX-format checkpoint served by test_aff2.main from best/
    (the main path, the counts set to 0 just before it) against the same
    weights as a .pth."""
    from auformer_torch import test_aff2
    from auformer_torch.core.checkpointing import read_checkpoint
    from auformer_torch.core.config import Config
    from auformer_torch.core.orbax_reader import read_orbax_checkpoint
    from auformer_torch.core.weights import state_dict_from_jax
    from auformer_torch.data.fixtures import write_orbax_checkpoint
    from auformer_torch.nn import build_model
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend
    from auformer_torch.sweep import default_sweep_bucket, make_sweep

    t_phase = time.perf_counter()
    fixtures = orbax_fixtures()
    work = Path(split["work"]) / "orbax"
    shutil.rmtree(work, ignore_errors=True)
    tree = seeded_jax_tree(SEED + 14)
    runs = {}
    for kind in ("orbax", "pth"):
        pretrain = work / kind / "experiments" / "avformer" / "pretrain"
        pretrain.mkdir(parents=True)
        runs[kind] = pretrain
    t0 = time.perf_counter()
    nbytes = write_orbax_checkpoint(str(runs["orbax"] / "best"), tree)
    write_s = time.perf_counter() - t0
    want_sd = state_dict_from_jax(tree)
    torch.save(want_sd, runs["pth"] / f"seed{SEED + 14}.pth")
    t0 = time.perf_counter()
    read_orbax_checkpoint(str(runs["orbax"] / "best"))
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = read_checkpoint(str(runs["orbax"] / "best"), "avformer")
    state_dict_s = time.perf_counter() - t0
    if set(sd) != set(want_sd) or not all(torch.equal(sd[k], want_sd[k])
                                          for k in want_sd):
        fail("the orbax checkpoint's state dict differs from "
             "state_dict_from_jax of the tree")

    argv = ["--root", split["root"], "--lmdb_label_dir",
            split["lmdb_label_dir"], "--cache_dir", split["cache_dir"],
            "--image_size", str(IMAGE), "--n_frames", str(FRAMES)]
    cfg = Config(image_size=IMAGE, n_frames=FRAMES, batch_size=BATCH)
    sizer = make_sweep(cfg, build_model(cfg))
    buckets = sum(-(-k // sizer._bucket_size(k, default_sweep_bucket(dev)))
                  for k in split["videos"].values())
    outs, seconds, launches, said = {}, {}, {}, {}
    cwd = os.getcwd()
    for kind in ("orbax", "pth"):
        os.chdir(runs[kind].parents[2])
        try:
            fused_attention.launches = 0
            mel_frontend.launches = 0
            t0 = time.perf_counter()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                outs[kind] = test_aff2.main(argv)
            torch.cuda.synchronize()
            seconds[kind] = time.perf_counter() - t0
            launches[kind] = {"attention": fused_attention.launches,
                              "mel": mel_frontend.launches}
            said[kind] = [line for line in text.getvalue().splitlines()
                          if "checkpoint" in line or "weight" in line]
        finally:
            os.chdir(cwd)
    want = {"attention": ATTN_PER_CALL * buckets, "mel": 0}
    if launches["orbax"] != want:
        fail(f"test_aff2.main from orbax best/ launched "
             f"{launches['orbax']}, expected {want}")
    best = os.path.join("experiments", "avformer", "pretrain", "best")
    if f"restored orbax checkpoint: {best}" not in said["orbax"]:
        fail(f"test_aff2.main did not report orbax best/: {said['orbax']}")
    check_submission(str(runs["orbax"].parents[2] / "results"),
                     split["videos"], outs["orbax"])
    if not np.array_equal(outs["orbax"], outs["pth"]):
        fail("test_aff2 from orbax best/ differs from the .pth of the same "
             f"weights by {np.abs(outs['orbax'] - outs['pth']).max()}")
    for path in (runs["orbax"].parents[2] / "results" / "au").iterdir():
        twin = runs["pth"].parents[2] / "results" / "au" / path.name
        if path.read_bytes() != twin.read_bytes():
            fail(f"submission file {path.name} differs between the orbax "
                 "and the .pth runs")
    emit("orbax", nvidia_smi=nvidia_smi(), fixtures=fixtures,
         checkpoint_bytes=nbytes, state_dict_tensors=len(want_sd),
         write_s=write_s, read_s=read_s, read_mb_per_s=nbytes / read_s / 1e6,
         state_dict_s=state_dict_s,
         state_dict_mb_per_s=nbytes / state_dict_s / 1e6,
         test_aff2={"rows": int(outs["orbax"].shape[0]),
                    "buckets": buckets, "seconds": seconds,
                    "launches": launches, "said": said,
                    "predictions_equal": True, "submissions_equal": True},
         phase_s=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)
    return launches["orbax"]


def mjpeg_planes(torch, unit: bytes) -> tuple:
    """nvJPEG's (Y, Cb, Cr) planes of a 4:2:0 JPEG, on the card."""
    from auformer_torch.data import native
    h, w, layout = native.jpeg_info(unit, "nvjpeg")
    if layout != 420:
        fail(f"a {layout} JPEG: the decode phase writes 4:2:0")
    planes = [torch.empty(s, dtype=torch.uint8, device="cuda")
              for s in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                        ((h + 1) // 2, (w + 1) // 2))]
    native.decode_jpeg_yuv(unit, *[p.data_ptr() for p in planes], h, w,
                           layout, torch.cuda.current_stream().cuda_stream,
                           "nvjpeg")
    return planes


@functools.lru_cache(maxsize=1)
def _decode_grid() -> tuple[np.ndarray, np.ndarray]:
    h, w = DECODE_SIZE
    yy, xx = np.mgrid[0:h, 0:w]
    return yy, xx


def decode_source(t: int) -> np.ndarray:
    """Frame t of the full-width stream: gradients and a moving box."""
    h, w = DECODE_SIZE
    yy, xx = _decode_grid()
    img = np.stack([xx * 255 // w, yy * 255 // h,
                    (xx + yy + 3 * t) * 255 // (h + w + 3 * DECODE_FRAMES)],
                   -1).astype(np.uint8)
    x0 = (9 * t) % (w - 240)
    img[240:480, x0:x0 + 240] = (220, 64, 96)
    return img


def decode_kernel_case(torch, dev, planes: list) -> dict:
    """yuv_rgb at 1280x720 against its plain version on the card, on the
    MJPEG route's 4:2:0 planes (the main path's); times and the bound."""
    from auformer_torch.ops import colour
    y, u, v = planes
    got = colour.yuv_rgb(y, u, v)
    want = colour.yuv_rgb_plain(y, u, v)
    torch.cuda.synchronize()
    h, w = y.shape
    err = (got.int() - want.int()).abs().max().item()
    if err:
        fail(f"yuv_rgb kernel differs from its plain version by {err}")
    ms, event_ms = timed(torch, lambda: colour.yuv_rgb(y, u, v), 200)
    plain_ms, _ = timed(torch, lambda: colour.yuv_rgb_plain(y, u, v), 20)
    nbytes = y.numel() + u.numel() + v.numel() + 3 * y.numel()
    bound_ms, bound_by = bound(nbytes, 0.0)
    return {"shape": [h, w], "max_abs_err": err, "ms": ms,
            "event_ms": event_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "library_ms": None}


def phase_decode(torch, dev) -> tuple[dict, dict]:
    """The decode phase: (a) NVDEC's caps and the H.264 route's refusal,
    (b) the committed fixtures, (c) the kernel at full width, (d) the
    full-width MJPEG stream through Video on the card, its launches counted
    with the counts set to 0 just before frames() and read just after.
    Returns (launches, the kernel's numbers)."""
    from auformer_torch.data import container, ingest, nvdec
    from auformer_torch.data.fixtures import write_mjpeg_avi
    from auformer_torch.data.native import encode_jpeg
    from auformer_torch.data.video import Video
    from auformer_torch.ops import colour

    t_phase = time.perf_counter()
    work = ROOT / ".cache" / "chip_smoke_decode"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # (a) NVDEC, asked; the H.264 and MPEG-4 frames raise naming A9
    caps = {}
    for codec in ("h264", "mpeg4"):
        try:
            c = nvdec.caps(codec)
        except RuntimeError as e:
            caps[codec] = {"refused": str(e)}
            continue
        c["fits"] = {f"{w}x{h}": (c["min_width"] <= w <= c["max_width"]
                                  and c["min_height"] <= h <= c["max_height"])
                     for w, h in ((112, 112), (1280, 720))}
        caps[codec] = c
    expected = json.loads((DECODE_FIXTURES / "expected.json").read_text())
    refusals = {}
    for name in expected:
        if name.startswith("mjpg"):
            continue
        try:
            Video(str(DECODE_FIXTURES / name), write=False).read_RGB(
                0, device=dev)
        except NotImplementedError as e:
            refusals[name] = "A9" in str(e)
        else:
            fail(f"{name}: H.264 frames decoded without a decoder")
    if not all(refusals.values()):
        fail(f"the H.264 refusals do not name A9: {refusals}")
    # (b) counts and timestamps of every fixture (the B-frame MP4's follow
    # the decoder's output order); the MJPEG fixture's frames on the card
    for name, want in expected.items():
        path = str(DECODE_FIXTURES / name)
        got = (Video(path, write=False).count_frames(), Path(
            ingest.extract_timestamps(path, str(work / "ts.txt"))
        ).read_text())
        if got != (want["count_frames"], want["timestamps"]):
            fail(f"{name}: count and timestamps {got[0]}, expected "
                 f"{want['count_frames']} and the JAX package's")
    fixture = Video(str(DECODE_FIXTURES / "mjpg_112.avi"), write=False)
    frames = [t.cpu() for t in fixture.frame_tensors(dev)]
    cv2_frames = np.load(DECODE_FIXTURES / "mjpg_112.npz")["frames"]
    diff = np.abs(np.stack([f.numpy() for f in frames]).astype(int)
                  - cv2_frames.astype(int))
    if diff.max() > MJPG_MAX or diff.mean() > MJPG_MEAN:
        fail(f"mjpg_112.avi on the card against cv2: max {diff.max()}, "
             f"mean {diff.mean()}")
    for k, unit in container.access_units(
            str(DECODE_FIXTURES / "mjpg_112.avi")):
        plain = colour.yuv_rgb_plain(*[p.cpu() for p in mjpeg_planes(
            torch, unit)])
        if not torch.equal(plain, frames[k]):
            fail(f"mjpg_112.avi frame {k}: the kernel's frame differs from "
                 "the plain conversion of nvJPEG's planes")
    fixtures = {"against_cv2": {"max": int(diff.max()),
                                "mean": float(diff.mean())},
                "counts_timestamps_equal": len(expected),
                "h264_refused": refusals}
    # (d) the full-width stream, written here: nvJPEG q90 frames in an AVI
    h, w = DECODE_SIZE
    path = str(work / "full.avi")
    t0 = time.perf_counter()
    write_mjpeg_avi(path, [encode_jpeg(decode_source(t), 90)
                           for t in range(DECODE_FRAMES)], w, h, 30.0)
    write_s = time.perf_counter() - t0
    video = Video(path, write=False)
    _, first = next(container.access_units(path))
    kernel = decode_kernel_case(torch, dev, mjpeg_planes(torch, first))
    torch.cuda.synchronize()
    colour.yuv_rgb.launches = 0
    t0 = time.perf_counter()
    decoded = list(video.frames(device=dev))         # the main path
    frames_s = time.perf_counter() - t0
    launches = {"attention": 0, "mel": 0,
                "yuv_rgb": colour.yuv_rgb.launches}
    if launches["yuv_rgb"] != DECODE_FRAMES or len(decoded) != DECODE_FRAMES:
        fail(f"frames(): {len(decoded)} frames, {launches} launches")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in video.frame_tensors(dev))
    torch.cuda.synchronize()
    tensors_s = time.perf_counter() - t0
    for k in DECODE_SEEKS:
        if not np.array_equal(video.read_RGB(k, device=dev), decoded[k]):
            fail(f"read_RGB({k}) differs from frames()[{k}]")
    if video.read_RGB(device=dev) is not None:
        fail("read_RGB() after the last frame is not None")
    units = [unit for _, unit in container.access_units(path)]
    for a, b in DECODE_PLAIN_RUNS:
        for k in range(a, b):
            plain = colour.yuv_rgb_plain(
                *[p.cpu() for p in mjpeg_planes(torch, units[k])])
            if not np.array_equal(plain.numpy(), decoded[k]):
                fail(f"frame {k}: the card's differs from the plain "
                     "conversion of its planes on the CPU")
    mae = max(float(np.abs(decoded[k].astype(int) - decode_source(k)
                           .astype(int)).mean())
              for k in range(0, DECODE_FRAMES, 15))
    if mae > DECODE_SOURCE_MAE or any(f.shape != (h, w, 3) for f in decoded):
        fail(f"full-width frames against their sources: MAE {mae}")
    stream = {"size": [w, h], "frames": DECODE_FRAMES, "fps": 30.0,
              "bytes": os.path.getsize(path), "write_s": write_s,
              "frames_s": frames_s, "frames_per_s": DECODE_FRAMES / frames_s,
              "s_per_frame": frames_s / DECODE_FRAMES,
              "frame_tensors_per_s": n / tensors_s,
              "launches": launches["yuv_rgb"], "seeks_equal": DECODE_SEEKS,
              "plain_equal_frames": [list(r) for r in DECODE_PLAIN_RUNS],
              "max_source_mae": mae}
    emit("decode", nvidia_smi=nvidia_smi(), nvdec_caps=caps,
         fixtures=fixtures, kernel=kernel, stream=stream,
         phase_s=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)
    return launches, kernel


def phase_quickstart(torch, dev) -> tuple[dict, list]:
    """The quickstart phase: ``python -m auformer_torch.quickstart`` (its
    ``main`` with no device argument: the card) into a work directory,
    its launches counted with the counts set to 0 just before it and read
    just after: 2 epochs of vformer fp32 training on host-augmented B=8
    batches, evaluation, and test-split inference with the submission
    files; then the trained weights (``latest.pth``) through the same
    inference on the CPU. Before it, the attention gradient check at its
    two sites. Returns (launches, the gradient cases)."""
    from auformer_torch import quickstart
    from auformer_torch.core.weights import (load_reference_state_dict,
                                             load_weights)
    from auformer_torch.data import Aff2TestDataset
    from auformer_torch.infer import run_inference
    from auformer_torch.nn import build_model
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend

    t_phase = time.perf_counter()
    grad_cases = attention_grad_cases(torch, dev, QUICKSTART_GRAD_SITES)
    work = ROOT / ".cache" / "chip_smoke_quickstart"
    shutil.rmtree(work, ignore_errors=True)

    # the dataset's and the inference's seconds: the quickstart's own
    # steps, wrapped here for the run (instrumentation of this script)
    seconds = {}
    steps = {"fixture": "make_dataset", "inference": "infer"}
    plain = {name: getattr(quickstart, fn) for name, fn in steps.items()}

    def timed_step(name):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = plain[name](*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            return out
        return run

    for name, fn in steps.items():
        setattr(quickstart, fn, timed_step(name))
    torch.cuda.synchronize()
    fused_attention.launches = fused_attention.backward_calls = 0
    mel_frontend.launches = 0
    t0 = time.perf_counter()
    try:
        history, predictions, _ = quickstart.main(["--workdir", str(work)])
    finally:
        for name, fn in steps.items():
            setattr(quickstart, fn, plain[name])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"attention": fused_attention.launches,
                "mel": mel_frontend.launches}
    backward_calls = fused_attention.backward_calls

    # forwards: the train steps, the eval steps (5 a 40-frame val split,
    # 4 where the epoch's shuffled downsample mask drops one of its rows)
    # and the test batches
    n_steps = sum(h["steps"] for h in history)
    eval_steps = QUICKSTART_FRAMES // QUICKSTART_BATCH
    infer_batches = -(-QUICKSTART_FRAMES // QUICKSTART_BATCH)
    fwd, bwd = VFORMER_ATTN_PER_STEP
    least = n_steps + len(history) * (eval_steps - 1) + infer_batches
    most = n_steps + len(history) * eval_steps + infer_batches
    if (len(history) != 2 or n_steps == 0 or launches["mel"] != 0
            or not fwd * least <= launches["attention"] <= fwd * most
            or launches["attention"] % max(fwd, 1)
            or backward_calls != bwd * n_steps):
        fail(f"quickstart: {len(history)} epochs, {n_steps} steps, "
             f"launches {launches} (expected attention {fwd} x "
             f"{least}-{most} forwards), backward calls {backward_calls}")
    for h in history:
        if not (np.isfinite(h["loss"])
                and np.isfinite(h["scores"]["AU"]["score"])):
            fail(f"quickstart epoch {h['epoch']} has no finite loss and AU "
                 f"score: {h}")

    cfg = quickstart.quickstart_config(str(work))
    dataset = Aff2TestDataset(cfg)
    test_rows = np.nonzero(dataset.test_ids)[0]
    want_rows = {}
    for i in test_rows:
        vid = os.path.dirname(dataset.image_path[i])
        want_rows[vid] = want_rows.get(vid, 0) + 1
    if sum(want_rows.values()) != QUICKSTART_FRAMES:
        fail(f"quickstart test split: {want_rows}")
    check_submission(str(work / "results"), want_rows, predictions,
                     n_rows=len(dataset))

    # the same weights through the same inference on the CPU
    model = build_model(cfg)
    load_weights(model, load_reference_state_dict(
        str(work / "exp" / "pretrain" / "latest.pth")))
    t0 = time.perf_counter()
    cpu = run_inference(cfg, model, result_path=str(work / "results_cpu"),
                        device="cpu")
    cpu_s = time.perf_counter() - t0
    rtol, atol = SLICE_TOL
    err = float(np.abs(predictions - cpu).max())
    if not (np.isfinite(predictions).all()
            and np.allclose(predictions, cpu, rtol=rtol, atol=atol)
            and predictions[test_rows, :12].any()):
        fail(f"quickstart: card inference against the CPU's, max |err| "
             f"{err}")

    epochs = [{"epoch": h["epoch"], "steps": h["steps"],
               "seconds": h["seconds"], "eval_s": h["eval_seconds"],
               "train_clips_per_s": h["steps"] * QUICKSTART_BATCH
               / h["seconds"],
               "step_timer_ms": {"data": h["data_ms"], "step": h["step_ms"]},
               "loss": h["loss"], "au_score": h["scores"]["AU"]["score"]}
              for h in history]
    emit("quickstart", nvidia_smi=nvidia_smi(), videos=4,
         frames_per_video=QUICKSTART_FRAMES, image=cfg.image_size,
         t=cfg.n_frames, batch=QUICKSTART_BATCH, dtype=cfg.compute_dtype,
         main_s=main_s, fixture_s=seconds["fixture"], epochs=epochs,
         inference_s=seconds["inference"],
         inference_label_frames_per_s=QUICKSTART_FRAMES
         / seconds["inference"],
         launches=launches, backward_calls=backward_calls,
         forwards=launches["attention"] // max(fwd, 1),
         launches_per_forward=fwd, backward_calls_per_step=bwd,
         submission={vid: rows for vid, rows in want_rows.items()},
         card_vs_cpu={"max_abs_err": err, "rtol": rtol, "atol": atol,
                      "cpu_inference_s": cpu_s},
         attention_gradient=grad_cases,
         phase_s=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)
    return launches, grad_cases


def phase_zoo(torch, dev, split: dict) -> dict:
    """The zoo's clip forwards, VformerSweep, SingleFrameSweep and
    vformer's run_inference_sweep over the dataset phase's split. Returns
    the launches of the bf16 main path runs, each counted from 0 just
    before it and read just after."""
    from auformer_torch import serve
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.data import Aff2TestDataset
    from auformer_torch.infer import make_infer_fn, run_inference_sweep
    from auformer_torch.nn import build_model
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend
    from auformer_torch.sweep import (SingleFrameSweep, VformerSweep,
                                      default_sweep_bucket)

    t_phase = time.perf_counter()
    launches = {"attention": 0, "mel": 0}

    def counted(run, want: dict, what: str, main: bool = True):
        fused_attention.launches = 0
        mel_frontend.launches = 0
        out = run()
        torch.cuda.synchronize()
        got = {"attention": fused_attention.launches,
               "mel": mel_frontend.launches}
        if got != want:
            fail(f"zoo {what} launched {got}, expected {want}")
        if main:
            for key in launches:
                launches[key] += got[key]
        return out

    def configs(name, modality, task, t, **kw):
        kw = dict(model_name=name, modality=modality, task=task, n_frames=t,
                  dilation=3 if t > 1 else 1,
                  image_size=ZOO_IMAGE.get(name, IMAGE), batch_size=BATCH,
                  **kw)
        return Config(compute_dtype="float32", **kw), Config(**kw)

    def loaded(cfg, sd):
        model = build_model(cfg)
        load_weights(model, sd)
        return model

    rs = np.random.RandomState(SEED + 7)
    models, weights = {}, {}
    for case, name, modality, task, t, n_attn, n_mel in ZOO_MODELS:
        cfg32, cfg16 = configs(name, modality, task, t)
        model32 = build_model(cfg32)
        sd = random_reference_state_dict(model32, SEED)
        load_weights(model32, sd)
        weights[case] = sd
        cpu_model = copy.deepcopy(model32)
        batch = zoo_batch(rs, name, modality, t, cfg32.image_size)
        on_card = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        want = {"attention": n_attn, "mel": n_mel}
        infer16 = make_infer_fn(cfg16, loaded(cfg16, sd))
        logits16 = counted(lambda: infer16(on_card), want, f"{case} bf16")
        infer32 = make_infer_fn(cfg32, model32)
        logits = counted(lambda: infer32(on_card), want, f"{case} fp32",
                         main=False).cpu()
        t0 = time.perf_counter()
        cpu_logits = make_infer_fn(cfg32, cpu_model, device="cpu")(batch)
        cpu_s = time.perf_counter() - t0
        err = (logits - cpu_logits).abs().max().item()
        if logits.shape != (BATCH, 21) or not torch.isfinite(logits).all():
            fail(f"zoo {case}: logits {tuple(logits.shape)} not finite")
        if not torch.allclose(logits, cpu_logits, rtol=SLICE_TOL[0],
                              atol=SLICE_TOL[1]):
            fail(f"zoo {case}: fp32 logits on the card differ from the CPU "
                 f"port by {err}")
        if name == "audio" and logits[:, 12:].abs().max().item() != 0.0:
            fail("zoo audio: the EX/VA slices are not zero")
        rel16 = ((logits16.float().cpu() - logits).norm()
                 / logits.norm()).item()
        if not (torch.isfinite(logits16).all() and rel16 <= ZOO_BF16_REL):
            fail(f"zoo {case}: bf16 logits {rel16} (norm-relative) from "
                 "fp32")
        rate16 = clips_per_s(torch, infer16, on_card, 20)
        prof = profile_calls(torch, lambda: [infer16(on_card)
                                             for _ in range(3)], 3)
        models[case] = dict(
            model=name, modality=modality, task=task, frames=t,
            image=cfg32.image_size, launches_per_forward=want,
            max_abs_err_fp32_vs_cpu=err,
            cpu_forward_s=cpu_s, bf16_vs_fp32_rel=rel16,
            clips_per_s_bf16=rate16,
            wall_ms_per_forward_bf16=1e3 * BATCH / rate16,
            device_ms_per_forward_bf16=(None if prof is None
                                        else prof["device_ms"]),
            device_idle_share_bf16=(None if prof is None else 1.0 - prof[
                "device_ms"] * rate16 / (1e3 * BATCH)),
            device_kernels_per_forward_bf16=(None if prof is None
                                             else prof["kernels"]))
        del model32, cpu_model, infer16, infer32, on_card
        torch.cuda.empty_cache()

    # vformer's dense sweep of the sweep phase's video
    frames, _, _ = sweep_video(SEED + 3)
    n = SWEEP_FRAMES
    bucket = default_sweep_bucket(dev)
    cfg32, cfg16 = configs("vformer", "V", "AU", FRAMES)
    model32 = loaded(cfg32, weights["vformer"])
    sweep32 = VformerSweep(cfg32, model32)
    n_buckets = -(-n // sweep32._bucket_size(n, bucket))
    logits32 = sweep32.sweep_video(frames, batch=bucket)
    sel = np.array(FEATURE_WINDOWS)
    idx = sweep32.window_indices(n)[sel]                  # black slot = n
    clips = np.where((idx == n)[..., None, None, None], 0,
                     frames[np.minimum(idx, n - 1)])
    infer32 = make_infer_fn(cfg32, model32)
    clip_logits = np.concatenate([
        infer32({"clip": clips[i:i + BATCH]}).cpu().numpy()
        for i in range(0, len(sel), BATCH)])
    vf_err = float(np.abs(logits32[sel] - clip_logits).max())
    if logits32.shape != (n, 21) or not np.allclose(
            logits32[sel], clip_logits, rtol=SWEEP_TOL[0],
            atol=SWEEP_TOL[1]):
        fail(f"zoo: the fp32 vformer sweep differs from its clip path by "
             f"{vf_err}")
    del sweep32, model32, infer32
    sweep16 = VformerSweep(cfg16, loaded(cfg16, weights["vformer"]))
    counts = BucketCounts(sweep16, fused_attention, mel_frontend)
    logits16 = counted(lambda: sweep16.sweep_video(frames, batch=bucket),
                       {"attention": VFORMER_ATTN_PER_BUCKET * n_buckets,
                        "mel": 0}, "vformer sweep")
    del sweep16.fused_sweep
    if counts.calls != [{"attention": VFORMER_ATTN_PER_BUCKET,
                         "mel": 0}] * n_buckets:
        fail(f"zoo: vformer sweep launches per bucket {counts.calls}")
    if not np.isfinite(logits16).all():
        fail("zoo: the bf16 vformer sweep is not finite")
    vf_rate, vf_walls = best_rate(
        torch, n, lambda: sweep16.sweep_video(frames, batch=bucket))
    vf_prof = profile_calls(
        torch, lambda: sweep16.sweep_video(frames, batch=bucket), n_buckets)
    # the host's share of a sweep: seconds in _to_device (pinned staging
    # and the queued copies of each bucket's frames and rows)
    staging = []
    plain_to_device = sweep16._to_device

    def staged(*arrays):
        t0 = time.perf_counter()
        out = plain_to_device(*arrays)
        staging.append(time.perf_counter() - t0)
        return out
    sweep16._to_device = staged
    t0 = time.perf_counter()
    sweep16.sweep_video(frames, batch=bucket)
    torch.cuda.synchronize()
    staged_wall = time.perf_counter() - t0
    del sweep16._to_device
    vformer_sweep = dict(
        frames=n, buckets=n_buckets, launches_per_bucket=counts.calls,
        fp32_vs_clip_max_abs_err=vf_err, rows=list(FEATURE_WINDOWS),
        rtol=SWEEP_TOL[0], atol=SWEEP_TOL[1],
        max_abs_diff_bf16_vs_fp32=float(np.abs(logits16 - logits32).max()),
        label_frames_per_s_bf16=vf_rate, walls=vf_walls,
        device_ms_per_bucket_bf16=(None if vf_prof is None
                                   else vf_prof["device_ms"]),
        device_idle_share_bf16=(None if vf_prof is None else 1.0 - (
            vf_prof["device_ms"] * n_buckets / (1e3 * min(vf_walls)))),
        host_to_device_s=sum(staging), host_to_device_wall_s=staged_wall,
        device_kernels_per_bucket_bf16=(None if vf_prof is None
                                        else vf_prof["kernels"]))
    del sweep16
    torch.cuda.empty_cache()

    # sformer through SingleFrameSweep: every frame of the same video
    cfg32, cfg16 = configs("sformer", "V", "AU", 1)
    model32 = loaded(cfg32, weights["sformer_au"])
    sweep32 = SingleFrameSweep(cfg32, model32)
    sf32 = sweep32.sweep_video(frames, batch=bucket)
    rows = frames[:SINGLE_FRAME_ROWS, None]
    infer32 = make_infer_fn(cfg32, model32)
    sf_clip = np.concatenate([infer32({"clip": rows[i:i + BATCH]}).cpu(
        ).numpy() for i in range(0, SINGLE_FRAME_ROWS, BATCH)])
    sf_err = float(np.abs(sf32[:SINGLE_FRAME_ROWS] - sf_clip).max())
    if sf32.shape != (n, 21) or not np.allclose(
            sf32[:SINGLE_FRAME_ROWS], sf_clip, rtol=SWEEP_TOL[0],
            atol=SWEEP_TOL[1]):
        fail(f"zoo: sformer's SingleFrameSweep differs from its clip "
             f"forward by {sf_err}")
    del sweep32, model32, infer32
    sweep16 = SingleFrameSweep(cfg16, loaded(cfg16, weights["sformer_au"]))
    sf_buckets = -(-n // bucket)
    sf16 = counted(lambda: sweep16.sweep_video(frames, batch=bucket),
                   {"attention": SFORMER_ATTN_PER_BUCKET * sf_buckets,
                    "mel": 0}, "sformer sweep")
    if not np.isfinite(sf16).all():
        fail("zoo: the bf16 sformer sweep is not finite")
    sf_rate, sf_walls = best_rate(
        torch, n, lambda: sweep16.sweep_video(frames, batch=bucket))
    sf_prof = profile_calls(
        torch, lambda: sweep16.sweep_video(frames, batch=bucket), sf_buckets)
    sformer_sweep = dict(
        frames=n, buckets=sf_buckets, fp32_vs_clip_max_abs_err=sf_err,
        clip_rows=SINGLE_FRAME_ROWS, label_frames_per_s_bf16=sf_rate,
        walls=sf_walls,
        device_ms_per_bucket_bf16=(None if sf_prof is None
                                   else sf_prof["device_ms"]),
        device_kernels_per_bucket_bf16=(None if sf_prof is None
                                        else sf_prof["kernels"]))
    del sweep16
    torch.cuda.empty_cache()

    # van on the same video and emonet on a synthetic 256x256 frame array
    # through SingleFrameSweep: fp32 against each's fp32 clip forward on the
    # first 64 frames, then the bf16 sweep's launches, label frames/s and
    # device ms per bucket
    single_frame = {}
    emonet_frames = np.random.RandomState(SEED + 8).randint(
        0, 256, (EMONET_FRAMES, ZOO_IMAGE["emonet"], ZOO_IMAGE["emonet"], 3),
        dtype=np.uint8)
    for case, video, sf_bucket in (("van", frames, bucket),
                                   ("emonet", emonet_frames,
                                    EMONET_SWEEP_BUCKET)):
        cfg32, cfg16 = configs(case, "V", "AU", 1)
        model32 = loaded(cfg32, weights[case])
        sweep32 = SingleFrameSweep(cfg32, model32)
        got32 = sweep32.sweep_video(video, batch=sf_bucket)
        rows = video[:SINGLE_FRAME_ROWS, None]
        infer32 = make_infer_fn(cfg32, model32)
        clip32 = np.concatenate([infer32({"clip": rows[i:i + BATCH]}).cpu(
            ).numpy() for i in range(0, SINGLE_FRAME_ROWS, BATCH)])
        err = float(np.abs(got32[:SINGLE_FRAME_ROWS] - clip32).max())
        if got32.shape != (len(video), 21) or not np.allclose(
                got32[:SINGLE_FRAME_ROWS], clip32, rtol=SWEEP_TOL[0],
                atol=SWEEP_TOL[1]):
            fail(f"zoo: {case}'s SingleFrameSweep differs from its clip "
                 f"forward by {err}")
        del sweep32, model32, infer32
        sweep16 = SingleFrameSweep(cfg16, loaded(cfg16, weights[case]))
        n_video = len(video)
        n_sf = -(-n_video // sf_bucket)
        got16 = counted(
            lambda: sweep16.sweep_video(video, batch=sf_bucket),
            {"attention": SINGLE_FRAME_ATTN_PER_BUCKET[case] * n_sf,
             "mel": 0}, f"{case} sweep")
        if not np.isfinite(got16).all():
            fail(f"zoo: the bf16 {case} sweep is not finite")
        torch.cuda.reset_peak_memory_stats()
        rate, walls = best_rate(
            torch, n_video, lambda: sweep16.sweep_video(video,
                                                        batch=sf_bucket))
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        prof = profile_calls(
            torch, lambda: sweep16.sweep_video(video, batch=sf_bucket), n_sf)
        single_frame[case] = dict(
            frames=n_video, image=int(video.shape[1]), bucket=sf_bucket,
            buckets=n_sf, fp32_vs_clip_max_abs_err=err,
            clip_rows=SINGLE_FRAME_ROWS, label_frames_per_s_bf16=rate,
            walls=walls, peak_memory_mb=peak_mb,
            bf16_vs_fp32_max_abs_diff=float(np.abs(got16 - got32).max()),
            device_ms_per_bucket_bf16=(None if prof is None
                                       else prof["device_ms"]),
            device_idle_share_bf16=(None if prof is None else 1.0 - (
                prof["device_ms"] * n_sf / (1e3 * min(walls)))),
            device_kernels_per_bucket_bf16=(None if prof is None
                                            else prof["kernels"]))
        del sweep16
        torch.cuda.empty_cache()

    # vformer's run_inference_sweep over the dataset phase's split, in
    # bf16 through the decode worker (4,000 test clips)
    cfg = Config(model_name="vformer", modality="V", task="AU",
                 n_frames=FRAMES, image_size=IMAGE,
                 **{k: split[k] for k in ("root", "lmdb_label_dir",
                                          "cache_dir")})
    model = loaded(cfg, weights["vformer"])
    dataset = Aff2TestDataset(cfg)
    sizer = VformerSweep(cfg, model)
    ds_buckets = sum(-(-k // sizer._bucket_size(k, bucket))
                     for k in split["videos"].values())
    workers = []

    class CountedWorker(serve.DecodeWorker):
        def __init__(self, cfg):
            super().__init__(cfg)
            workers.append(self.startup_seconds)
    serve.DecodeWorker, plain_worker = CountedWorker, serve.DecodeWorker
    result_dir = str(split["work"] / "zoo_vformer")
    try:
        t0 = time.perf_counter()
        out = counted(lambda: run_inference_sweep(
            cfg, model, dataset=dataset, result_path=result_dir),
            {"attention": VFORMER_ATTN_PER_BUCKET * ds_buckets, "mel": 0},
            "vformer run_inference_sweep")
        ds_s = time.perf_counter() - t0
    finally:
        serve.DecodeWorker = plain_worker
    if len(workers) != 1:
        fail(f"zoo: run_inference_sweep started {len(workers)} decode "
             "workers, not 1")
    check_submission(result_dir, split["videos"], out)
    if not np.isfinite(out).all() or not out[:, 12:].any():
        fail("zoo: vformer's submission logits are not finite 21-column rows")
    emit("zoo", batch=BATCH, image=IMAGE, tol=list(SLICE_TOL),
         bf16_rel_tol=ZOO_BF16_REL, models=models,
         vformer_sweep=vformer_sweep, sformer_sweep=sformer_sweep,
         single_frame_sweeps=single_frame,
         vformer_dataset={"label_frames": int(out.shape[0]),
                          "buckets": ds_buckets, "seconds": ds_s,
                          "label_frames_per_s_bf16": out.shape[0] / ds_s,
                          "worker_startup_s": workers[0]},
         launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


def attention_grad_cases(torch, dev, sites=GRAD_SITES) -> list[dict]:
    """The attention autograd Function (the kernel forward, the recomputing
    backward) against autograd through the plain version at ``sites``, on
    the head split of a fused QKV projection: the output and the
    projection's gradient. Times per call: the kernel forward, the backward
    (``attention_backward_reference``), the plain version's forward +
    backward through autograd, and SDPA's forward + backward."""
    import torch.nn.functional as F
    from auformer_torch.ops.attention import (attention_backward_reference,
                                              attention_reference,
                                              fused_attention)
    rs = np.random.RandomState(SEED + 5)
    cases = []
    for site, n, d, batch in sites:
        base = rs.randn(batch, n, 3 * HEADS * d).astype(np.float32)
        grad = rs.randn(batch, HEADS, n, d).astype(np.float32)
        scale = d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.from_numpy(grad).to(dev, dtype)

            def views(qkv):
                return qkv.reshape(batch, n, 3, HEADS, d).permute(
                    2, 0, 3, 1, 4).unbind(0)

            results = []
            for fn in (fused_attention, attention_reference):
                qkv = torch.from_numpy(base).to(dev, dtype).requires_grad_()
                out = fn(*views(qkv), scale)
                out.backward(g)
                results.append((out.detach().float(), qkv.grad.float()))
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            rtol, atol = ATTN_TOL[dname]
            errs = [(a - b).abs().max().item()
                    for a, b in zip(*results)]
            if not all(torch.allclose(a, b, rtol=rtol, atol=atol)
                       for a, b in zip(*results)):
                fail(f"attention gradient {site} {dname}: max |err| {errs}")

            qkv = torch.from_numpy(base).to(dev, dtype).requires_grad_()
            q, k, v = views(qkv.detach())
            with torch.no_grad():
                fwd, fwd_ev = timed(
                    torch, lambda: fused_attention(q, k, v, scale), 50)
            bwd, bwd_ev = timed(torch, lambda: attention_backward_reference(
                q, k, v, g, scale), 50)
            plain, plain_ev = timed(torch, lambda: torch.autograd.grad(
                attention_reference(*views(qkv), scale), qkv, g), 20)
            lib, lib_ev = timed(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*views(qkv), scale=scale),
                qkv, g), 20)
            numel, size = q.numel(), q.element_size()
            flops = 4 * batch * HEADS * n * n * d
            peak = PEAK_FLOPS["f32" if dtype == torch.float32 else "bf16"]
            # forward: q, k, v read, o written; backward: q, k, v and the
            # output gradient read, dq, dk, dv written, 10 B H N^2 D f32
            # operations (S recomputed, dV, dP, dQ, dK)
            fb_ms, fb_by = bound(4 * numel * size, flops / peak)
            bb_ms, bb_by = bound(7 * numel * size,
                                 2.5 * flops / PEAK_FLOPS["f32"])
            cases.append(dict(
                site=site, dtype=dname, shape=[batch, HEADS, n, d],
                max_abs_err_out=errs[0], max_abs_err_grad=errs[1],
                rtol=rtol, atol=atol, forward_ms=fwd, backward_ms=bwd,
                plain_fwd_bwd_ms=plain, library_fwd_bwd_ms=lib,
                forward_bound_ms=fb_ms, forward_bound_by=fb_by,
                backward_bound_ms=bb_ms, backward_bound_by=bb_by,
                event_ms={"forward": fwd_ev, "backward": bwd_ev,
                          "plain": plain_ev, "library": lib_ev}))
    return cases


def train_batch(rs, b: int, symmetric: bool = False) -> dict:
    """uint8 clips (left-right symmetric ones: the random flip is the
    identity), host features and labels with an ignored row."""
    if symmetric:
        half = rs.randint(0, 256, (b, FRAMES, IMAGE, IMAGE // 2, 3))
        clip = np.concatenate([half, half[:, :, :, ::-1]], axis=3)
    else:
        clip = rs.randint(0, 256, (b, FRAMES, IMAGE, IMAGE, 3))
    au = rs.randint(0, 2, (b, 12)).astype(np.int8)
    au[0, 0] = -1
    return {"clip": np.ascontiguousarray(clip.astype(np.uint8)),
            "audio_features": rs.randn(b, 1, 64, 1001).astype(np.float32),
            "AU": au, "EX": rs.randint(-1, 7, (b, 1)).astype(np.int8),
            "VA": rs.uniform(-1, 1, (b, 2)).astype(np.float32)}


def on(torch, batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def head_qkv_grads(torch, model, cfg, batch) -> dict:
    """One train-mode forward and backward of the full model (frozen
    streams, no flip, no dropout): the fusion head's to_qkv gradients."""
    from auformer_torch.nn import loss_suite
    from auformer_torch.parallel import step as tstep
    tstep.make_optimizer(cfg, model)
    model.train()
    out = tstep._forward(cfg, model, tstep.prep_batch(batch, train=False))
    loss, _ = tstep.task_loss(loss_suite(model), cfg.task, out,
                              tstep._labels_of(batch))
    loss.backward()
    return {n: p.grad.detach().float() for n, p in model.named_parameters()
            if n.startswith("au_head") and n.endswith("to_qkv.weight")}


def model_gradient_check(torch, dev, sd) -> dict:
    """Fault 1: after one backward of the full fp32 model (B=16) the fusion
    head's to_qkv gradients are non-zero and equal the plain route's (every
    attention through autograd of ``attention_reference``)."""
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.nn import blocks, build_model
    from auformer_torch.ops.attention import (attention_reference,
                                              fused_attention, output_buffer)
    cfg = Config(compute_dtype="float32", image_size=IMAGE, n_frames=FRAMES,
                 dropout_rate=0.0)
    batch = on(torch, train_batch(np.random.RandomState(SEED + 6), 16), dev)
    grads = []
    for route in ("kernel", "plain"):
        model = build_model(cfg, dtype=torch.float32)
        load_weights(model, sd)
        model.to(dev)
        if route == "plain":
            blocks.fused_attention = (
                lambda q, k, v, scale, mask=None:
                output_buffer(q).copy_(attention_reference(q, k, v, scale)))
        try:
            before = (fused_attention.launches,
                      fused_attention.backward_calls)
            grads.append(head_qkv_grads(torch, model, cfg, batch))
            counted = (fused_attention.launches - before[0],
                       fused_attention.backward_calls - before[1])
        finally:
            blocks.fused_attention = fused_attention
        if route == "kernel" and counted != (ATTN_FWD_PER_STEP,
                                             ATTN_BWD_PER_STEP):
            fail(f"one train forward/backward launched {counted}")
        del model
    kernel, plain = grads
    errs = {}
    for name, want in plain.items():
        got = kernel[name]
        errs[name] = (got - want).abs().max().item()
        if not (got.abs().sum().item() > 0 and torch.allclose(
                got, want, rtol=STEP_TOL[0],
                atol=STEP_TOL[1] * want.abs().max().item())):
            fail(f"fusion head {name} gradient: kernel route "
                 f"{got.abs().sum().item()} vs plain, max |err| "
                 f"{errs[name]}")
    return {"layers": len(plain), "max_abs_err": max(errs.values()),
            "grad_abs_sum": {n: g.abs().sum().item()
                             for n, g in kernel.items()}}


def card_vs_cpu_step(torch, dev, sd) -> dict:
    """One fp32 train step (full width, B=4, dropout 0, symmetric clips, no
    augmentation) on the card and on the CPU: the loss, every trainable
    gradient, the fusion head's updated parameters (Adam's first step
    moves each by +-lr, so an element whose gradient is ~0 may step
    either way: 99.9 % within STEP_TOL, all within 2 lr) and every
    BatchNorm statistic."""
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.nn import build_model, loss_suite
    from auformer_torch.parallel import step as tstep
    cfg = Config(compute_dtype="float32", image_size=IMAGE, n_frames=FRAMES,
                 dropout_rate=0.0, batch_size=4, learning_rate=1e-3)
    batch = train_batch(np.random.RandomState(SEED + 7), 4, symmetric=True)
    runs = []
    for device in (dev, torch.device("cpu")):
        model = build_model(cfg, dtype=torch.float32)
        load_weights(model, sd)
        model.to(device)
        state = tstep.create_train_state(cfg, model)
        step = tstep.make_train_step(cfg, model, loss_suite(model))
        grads = {}
        apply = state.apply_gradients

        def capture(state=state, grads=grads, apply=apply):
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in state.model.named_parameters()
                          if p.requires_grad})
            apply()
        state.apply_gradients = capture
        t0 = time.perf_counter()
        metrics = step(state, on(torch, batch, device),
                       torch.Generator(device).manual_seed(SEED))
        loss = float(metrics["loss"])
        runs.append((loss, grads, {k: v.detach().cpu() for k, v in
                                   model.state_dict().items()},
                     time.perf_counter() - t0))
    (loss_card, g_card, sd_card, _), (loss_cpu, g_cpu, sd_cpu, cpu_s) = runs
    rtol, atol = STEP_TOL
    if not abs(loss_card - loss_cpu) <= atol + rtol * abs(loss_cpu):
        fail(f"fp32 train step loss {loss_card} on the card, {loss_cpu} on "
             f"the CPU")
    grad_err = max((g_card[n] - g).abs().max().item() for n, g in
                   g_cpu.items())
    if not all(torch.allclose(g_card[n], g, rtol=rtol, atol=atol)
               for n, g in g_cpu.items()):
        fail(f"fp32 train step gradients differ from the CPU by {grad_err}")
    close, param_err, stats_err = [], 0.0, 0.0
    for key, want in sd_cpu.items():
        got = sd_card[key]
        diff = (got.float() - want.float()).abs()
        if key.startswith("au_head"):
            param_err = max(param_err, diff.max().item())
            close.append((diff <= atol + rtol * want.abs()).reshape(-1))
        elif "running_" in key:
            stats_err = max(stats_err, diff.max().item())
            if not torch.allclose(got, want, rtol=STATS_TOL[0],
                                  atol=STATS_TOL[1]):
                fail(f"BatchNorm statistic {key} differs from the CPU by "
                     f"{diff.max().item()}")
        elif not torch.equal(got, want):
            fail(f"frozen {key} moved in the train step")
    share = torch.cat(close).float().mean().item()
    if param_err > 2 * cfg.learning_rate or share < 0.999:
        fail(f"updated fusion head parameters differ from the CPU: max "
             f"{param_err}, {share} within tolerance")
    return {"loss_card": loss_card, "loss_cpu": loss_cpu,
            "grad_max_abs_err": grad_err, "param_max_abs_diff": param_err,
            "param_share_within_tol": share,
            "bn_stats_max_abs_err": stats_err, "rtol": rtol, "atol": atol,
            "cpu_step_s": cpu_s}


def augment_check(torch, dev) -> dict:
    """Every op of the vocabulary at both signs through the augmentation
    stages and a whole slot, on the card against the CPU (112x112 frames):
    LUT ops and nearest warps exact, blends and bicubic warps +-1 level.
    And augment_clips_device's time at the main path's (64, 16) clips."""
    from auformer_torch.ops import augment_device as aug
    rs = np.random.RandomState(SEED + 8)
    ops = np.tile(np.arange(15), 4)
    signed = np.isin(ops, [1, 2, 3, 4, 5, 9, 10, 13, 14])
    mags = np.array([0, 0.2, 0.3, 0.3, 0.45, 26.67, 0, 5, 142.2, 0.6, 0.3,
                     0, 0, 0.7, 0.5])[ops]
    m = (mags * np.where(signed & (np.arange(len(ops)) >= 30), -1.0, 1.0)
         ).astype(np.float32)
    x = rs.randint(0, 256, (len(ops), IMAGE, IMAGE, 3)).astype(np.uint8)
    x[::7] //= 3
    cpu = [torch.from_numpy(a) for a in (x, ops, m)]
    card = [a.to(dev) for a in cpu]
    loose = torch.from_numpy(np.isin(ops, [1, 2, 13, 14]))
    worst = {}
    for name in ("_geo_stage", "_lut_stage", "_slot_apply"):
        diff = (getattr(aug, name)(*card).cpu().int()
                - getattr(aug, name)(*cpu).int()).abs().amax(dim=(1, 2, 3))
        worst[name] = {"exact_ops": int(diff[~loose].max()),
                       "blend_bicubic_ops": int(diff[loose].max())}
        if diff[~loose].max() > 0 or diff[loose].max() > 1:
            fail(f"augmentation {name} on the card differs from the CPU: "
                 f"{worst[name]}")
    factor = torch.from_numpy(1.0 + m)
    for name in ("_color_stage", "_sharp_stage"):
        d = (getattr(aug, name)(card[0], factor.to(dev)).cpu().int()
             - getattr(aug, name)(cpu[0], factor).int()).abs().max().item()
        worst[name] = d
        if d > 1:
            fail(f"augmentation {name} on the card differs from the CPU by "
                 f"{d}")
    clips = torch.from_numpy(rs.randint(
        0, 256, (TRAIN_BATCH, FRAMES, IMAGE, IMAGE, 3)).astype(np.uint8)
        ).to(dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    ms, ev = timed(torch, lambda: aug.augment_clips_device(clips, gen), 5,
                   warmup=1)
    return {"max_level_diff": worst, "augment_b64_ms": ms,
            "augment_b64_event_ms": ev}


def train_argv(work: Path, exp: str, *extra,
               device_augment: bool = True) -> list[str]:
    """train.main's flags on the train split: B=64, full width, 2 epochs,
    the AutoAugment in the step (``device_augment``) or on the host."""
    return ["--root", str(work / "root"), "--lmdb_label_dir",
            str(work / "labels"), "--cache_dir", str(work / "cache"),
            "--exp_dir", str(work / exp), "--image_size", str(IMAGE),
            "--n_frames", str(FRAMES), "--batch_size", str(TRAIN_BATCH),
            "--downsample_rate", "2", "--epochs", "2",
            *(("--device_augment",) if device_augment else ()),
            "--seed", str(SEED), *extra]


class attention_site_ranges:
    """While active, each attention forward (the kernel) and backward (the
    plain recompute) runs inside a profiler range named by its site,
    ``attention_{fwd,bwd}_N{tokens}_D{dim}``: the trace's device time per
    site (a forward's from the range's device-side span, which holds its
    one kernel; a backward's from the kernels of the plain ops inside it).
    Instrumentation of this script; the port is untouched."""

    def __init__(self, torch):
        from auformer_torch.ops import attention as tatt
        self.torch, self.tatt = torch, tatt

    def __enter__(self):
        tatt, record = self.tatt, self.torch.profiler.record_function
        self.plain = (tatt._attention_forward,
                      tatt.attention_backward_reference)
        fwd, bwd = self.plain

        def forward(q, k, v, scale):
            with record(f"attention_fwd_N{q.shape[2]}_D{q.shape[3]}"):
                return fwd(q, k, v, scale)

        def backward(q, k, v, g, scale):
            with record(f"attention_bwd_N{q.shape[2]}_D{q.shape[3]}"):
                return bwd(q, k, v, g, scale)
        tatt._attention_forward = forward
        tatt.attention_backward_reference = backward
        return self

    def __exit__(self, *exc):
        (self.tatt._attention_forward,
         self.tatt.attention_backward_reference) = self.plain


def profile_steps(torch, dev, model, work: Path, argv: list,
                  per_step_want: tuple, sites: dict) -> dict:
    """5 bf16 train steps on loader batches: device ms, kernels and the
    idle share per step (torch.profiler), the wall per step, one step's
    attention launches and backward calls (``per_step_want``), the
    attention forward and backward device ms per step at each of
    ``sites`` (name -> (tokens, head dim)); and the loader alone (4
    threads: JPEG reads and host features) per batch, with the card
    idle."""
    from auformer_torch import train_lib
    from auformer_torch.core.config import parse_opt
    from auformer_torch.data import (Aff2CompDataset, DataLoader,
                                     SubsetSequentialSampler)
    from auformer_torch.nn import loss_suite
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.parallel import step as tstep
    cfg = parse_opt(argv)
    ds = Aff2CompDataset(cfg)
    ds.set_modes(list(model.modes))
    ids = np.nonzero(ds.train_ids)[0][::2][:5 * TRAIN_BATCH]
    keys = train_lib.device_batch_keys(model, cfg)
    t0 = time.perf_counter()
    host = list(DataLoader(ds, TRAIN_BATCH, SubsetSequentialSampler(ids),
                           num_threads=cfg.host_threads, drop_last=True))
    loader_s = (time.perf_counter() - t0) / len(host)
    batches = [train_lib.to_device(b, keys, dev) for b in host]
    state = tstep.create_train_state(cfg, model)
    step = tstep.make_train_step(cfg, model, loss_suite(model))
    gen = torch.Generator(dev).manual_seed(SEED)

    def run():
        for b in batches:
            step(state, b, gen)
    run()
    torch.cuda.synchronize()
    fused_attention.launches = fused_attention.backward_calls = 0
    step(state, batches[0], gen)
    torch.cuda.synchronize()
    per_step = {"forward": fused_attention.launches,
                "backward": fused_attention.backward_calls}
    if per_step != dict(zip(("forward", "backward"), per_step_want)):
        fail(f"attention per train step of {cfg.model_name}: {per_step}")
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    with attention_site_ranges(torch):
        prof = device_profile(torch, run, cpu=True)
    # aggregated once: each key_averages() call walks the session's tens of
    # thousands of CPU and device events again
    averages = [] if prof is None else prof.key_averages()
    # the ranges' device-side spans overlap the kernels they hold: kernels
    # only in the step's totals
    events = [
        e for e in averages
        if on_device(e) and e.device_time_total > 0
        and not e.key.startswith(("attention_fwd_N", "attention_bwd_N"))]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    device_ms = (None if prof is None else
                 sum(e.device_time_total for e in events) / 1e3 / len(batches))

    def traced(matches) -> dict | None:
        """Device ms and calls per step of the trace's events ``matches``
        takes (a CPU op's or range's device time: the kernels it
        launched)."""
        if prof is None:
            return None
        found = [e for e in averages if matches(e)]
        return {"ms_per_step": sum(e.device_time_total for e in found)
                / 1e3 / len(batches),
                "calls_per_step": sum(e.count for e in found) / len(batches)}

    def forward_span(name):
        """The device-side span of a forward range: its one kernel (the
        ctypes launch belongs to no CPU op)."""
        return traced(lambda e: on_device(e) and e.key == name)

    def backward_kernels(name):
        """The kernels of a backward range's plain ops."""
        return traced(lambda e: not on_device(e) and e.key == name)
    return {"model": cfg.model_name, "steps": len(batches),
            "wall_ms_per_step": wall_ms,
            "loader_alone_s_per_batch": loader_s,
            "device_ms_per_step": device_ms,
            "device_idle_share": (None if device_ms is None
                                  else 1.0 - device_ms / wall_ms),
            "device_kernels_per_step": (None if prof is None else sum(
                e.count for e in events) / len(batches)),
            "attention_per_step": per_step,
            # the attention kernel's launches at every site of the step, and
            # the recomputing backward (plain PyTorch) at every trained site
            "attention_in_step": {
                "kernel": traced(lambda e: on_device(e)
                                 and "attention_" in e.key
                                 and "_kernel" in e.key),
                "backward": traced(lambda e: not on_device(e) and e.key
                                   == "_FusedAttentionBackward"),
                "by_site": {site: {
                    "forward": forward_span(f"attention_fwd_N{n}_D{d}"),
                    "backward": backward_kernels(
                        f"attention_bwd_N{n}_D{d}")}
                    for site, (n, d) in sites.items()}},
            "top": [{"name": e.key[:80],
                     "ms_per_step": e.device_time_total / 1e3 / len(batches),
                     "calls_per_step": e.count / len(batches)}
                    for e in events[:15]]}


def zoo_step_batch(rs, name: str, modality: str, t: int, image: int,
                   b: int, symmetric: bool = True) -> dict:
    """A train batch of a zoo model: uint8 clips (left-right symmetric:
    the random flip is the identity) of its frames and channels, host
    audio features where it takes audio, labels with an ignored row."""
    batch = {}
    if name != "audio":
        channels = 4 if modality == "V;M" else 3
        if symmetric:
            half = rs.randint(0, 256, (b, t, image, image // 2, channels))
            clip = np.concatenate([half, half[:, :, :, ::-1]], axis=3)
        else:
            clip = rs.randint(0, 256, (b, t, image, image, channels))
        batch["clip"] = np.ascontiguousarray(clip.astype(np.uint8))
    if name in ("audio", "tsav"):
        batch["audio_features"] = rs.randn(b, 1, 64, 1001).astype(np.float32)
    au = rs.randint(0, 2, (b, 12)).astype(np.int8)
    au[0, 0] = -1
    batch.update(AU=au, EX=rs.randint(-1, 7, (b, 1)).astype(np.int8),
                 VA=rs.uniform(-1, 1, (b, 2)).astype(np.float32))
    return batch


def zoo_card_vs_cpu_steps(torch, dev) -> dict:
    """One fp32 train step (ZOO_STEP's size, dropout 0, no augmentation,
    symmetric clips) of each non-avformer model on the card and on the
    CPU: the loss, every gradient (the bound of ZOO_STEP's comment) and
    every BatchNorm statistic after the step."""
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.nn import build_model, loss_suite
    from auformer_torch.nn.registry import SINGLE_FRAME
    from auformer_torch.parallel import step as tstep
    rtol, atol = STEP_TOL
    results = {}
    for i, (name, modality) in enumerate(ZOO_STEP_MODELS):
        t = 1 if name in SINGLE_FRAME else ZOO_STEP["frames"]
        cfg = Config(model_name=name, modality=modality, task="AU",
                     n_frames=t, dilation=1, image_size=ZOO_STEP["image"],
                     compute_dtype="float32", dropout_rate=0.0,
                     batch_size=ZOO_STEP["batch"], learning_rate=1e-3)
        sd = random_reference_state_dict(build_model(cfg), SEED + i)
        rs = np.random.RandomState(SEED + 20 + i)
        batch = zoo_step_batch(rs, name, modality, t, ZOO_STEP["image"],
                               ZOO_STEP["batch"])
        moved = [{k: (v * (1 + 1e-6 * rs.randn(*v.shape))).astype(np.float32)
                  for k, v in sd.items()} for _ in range(ZOO_STEP_MOVES)]
        runs = []
        for weights, device in ((sd, dev), (sd, torch.device("cpu")),
                                *((w, torch.device("cpu")) for w in moved)):
            model = build_model(cfg)
            load_weights(model, weights)
            model.to(device)
            state = tstep.create_train_state(cfg, model)
            step = tstep.make_train_step(cfg, model, loss_suite(model))
            grads = {}
            apply = state.apply_gradients

            def capture(model=model, grads=grads, apply=apply):
                # tformer's inner AU head's logit weights take no part in
                # the loss: no gradient
                grads.update({n: (torch.zeros(p.shape) if p.grad is None
                                  else p.grad.detach().cpu().clone())
                              for n, p in model.named_parameters()})
                apply()
            state.apply_gradients = capture
            t0 = time.perf_counter()
            loss = float(step(state, on(torch, batch, device),
                              torch.Generator(device).manual_seed(SEED))[
                                  "loss"])
            runs.append((loss, grads, {k: v.detach().cpu() for k, v in
                                       model.state_dict().items()
                                       if "running_" in k},
                         time.perf_counter() - t0))
            del model, state
        (loss_card, g_card, st_card, card_s), (loss_cpu, g_cpu, st_cpu,
                                               cpu_s) = runs[:2]
        if not (np.isfinite(loss_card)
                and abs(loss_card - loss_cpu) <= atol + rtol * abs(loss_cpu)):
            fail(f"zoo step {name}: fp32 loss {loss_card} on the card, "
                 f"{loss_cpu} on the CPU")
        worst = 0.0
        for key, want in g_cpu.items():
            bound = (rtol * want.norm().item()
                     + atol * want.numel() ** 0.5
                     + 3 * max((want - run[1][key]).norm().item()
                               for run in runs[2:]))
            excess = (g_card[key] - want).norm().item() / bound
            worst = max(worst, excess)
            if excess > 1.0:
                fail(f"zoo step {name}: gradient {key} on the card differs "
                     f"from the CPU by {(g_card[key] - want).norm().item()}"
                     f" (bound {bound})")
        stats_err = 0.0
        for key, want in st_cpu.items():
            stats_err = max(stats_err,
                            (st_card[key] - want).abs().max().item())
            if not torch.allclose(st_card[key], want, rtol=STATS_TOL[0],
                                  atol=STATS_TOL[1]):
                fail(f"zoo step {name}: BatchNorm statistic {key} differs "
                     f"from the CPU by {stats_err}")
        results[name] = {"loss_card": loss_card, "loss_cpu": loss_cpu,
                         "grad_worst_share_of_bound": worst,
                         "tensors": len(g_cpu),
                         "bn_stats_max_abs_err": stats_err,
                         "card_step_s": card_s, "cpu_step_s": cpu_s}
        torch.cuda.empty_cache()
    return results


def zoo_train_steps(torch, dev) -> dict:
    """ZOO_TRAIN_STEPS bf16 train steps (--device_augment, B=64) of each
    zoo model but avformer and vformer at full width (112x112, or emonet's
    256x256; T=16, or 1) on ready device batches, after one warm-up step:
    attention launches and backward calls per step (ZOO_TRAIN_ATTN),
    device ms and kernels per step, wall ms per step, peak memory; then
    the same steps graphed (``zoo_graph_check``), under "graph"."""
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.nn import build_model, loss_suite
    from auformer_torch.nn.registry import SINGLE_FRAME
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.parallel import step as tstep
    results = {}
    for i, (name, modality) in enumerate(ZOO_STEP_MODELS):
        if name == "vformer":
            continue
        t = 1 if name in SINGLE_FRAME else FRAMES
        image = ZOO_IMAGE.get(name, IMAGE)
        cfg = Config(model_name=name, modality=modality, task="AU",
                     n_frames=t, image_size=image, batch_size=TRAIN_BATCH,
                     device_augment=True)
        model = build_model(cfg)
        load_weights(model, random_reference_state_dict(model, SEED + i))
        model.to(dev)
        batch = on(torch, zoo_step_batch(np.random.RandomState(SEED + 40 + i),
                                         name, modality, t, image,
                                         TRAIN_BATCH, symmetric=False), dev)
        state = tstep.create_train_state(cfg, model)
        step = tstep.make_train_step(cfg, model, loss_suite(model))
        gen = torch.Generator(dev).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        step(state, batch, gen)
        torch.cuda.synchronize()
        fused_attention.launches = fused_attention.backward_calls = 0
        losses = [step(state, batch, gen)["loss"]]
        torch.cuda.synchronize()
        want = ZOO_TRAIN_ATTN[name]
        if (fused_attention.launches, fused_attention.backward_calls) != (
                want, want):
            fail(f"zoo train step {name}: attention {fused_attention.launches}"
                 f" launches, {fused_attention.backward_calls} backward "
                 f"calls, expected {want} each")
        t0 = time.perf_counter()
        losses += [step(state, batch, gen)["loss"]
                   for _ in range(ZOO_TRAIN_STEPS - 1)]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (ZOO_TRAIN_STEPS - 1)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        losses = [float(v) for v in losses]
        if not np.isfinite(losses).all():
            fail(f"zoo train step {name}: losses {losses}")
        prof = profile_calls(torch, lambda: [step(state, batch, gen) for _ in
                                             range(ZOO_TRAIN_STEPS)],
                             ZOO_TRAIN_STEPS)
        results[name] = {
            "frames": t, "image": image, "losses": losses,
            "attention_per_step": want, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": None if prof is None else prof["device_ms"],
            "device_kernels_per_step": (None if prof is None
                                        else prof["kernels"]),
            "device_idle_share": (None if prof is None
                                  else 1.0 - prof["device_ms"] / wall_ms),
            "peak_memory_mb": peak_mb}
        del state, step
        results[name]["graph"] = zoo_graph_check(torch, cfg, model, batch,
                                                 (want, want))
        del model, batch
        torch.cuda.empty_cache()
    return results


def zoo_graph_check(torch, cfg, model, batch: dict, per_step: tuple) -> dict:
    """From the weights after the eager bf16 steps, all with the
    capturable Adam: GRAPH_STEPS steps on ``batch`` as dispatches of
    GRAPH_K through the graph (the warm-up, then a capture and its
    replays) against the same steps eager, twice for their spread (under
    ``deterministic``): the losses as ``graph_against_eager`` holds them.
    Then, with the default algorithms, a graph of the same steps: one
    dispatch of replays timed (wall ms per step) and one profiled (device
    ms, kernels, idle share), the attention launches and backward calls
    per replayed step (``per_step``), peak memory with the graph."""
    from auformer_torch.ops.attention import fused_attention
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [batch] * GRAPH_STEPS
    seeds = [SEED + 200 + i for i in range(GRAPH_STEPS)]
    with deterministic(torch):
        eager = [k_step_run(torch, cfg, model, start, batches, seeds)[0]
                 for _ in range(2)]
        losses = k_step_run(torch, cfg, model, start, batches, seeds,
                            k=GRAPH_K)[0]
    checked = graph_against_eager(torch, f"zoo graph {cfg.model_name}",
                                  {"loss": losses}, {"loss": eager[0]},
                                  {"loss": eager[1]})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, _, step_k, state = k_step_run(torch, cfg, model, start,
                                     batches[:2 * GRAPH_K],
                                     seeds[:2 * GRAPH_K], k=GRAPH_K)
    stacked = {key: torch.stack([batch[key]] * GRAPH_K) for key in batch}

    def dispatch():
        step_k(state, stacked, seeds[:GRAPH_K])
    torch.cuda.synchronize()
    fused_attention.launches = fused_attention.backward_calls = 0
    t0 = time.perf_counter()
    dispatch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / GRAPH_K
    counted = (fused_attention.launches / GRAPH_K,
               fused_attention.backward_calls / GRAPH_K)
    if counted != per_step:
        fail(f"zoo graph {cfg.model_name}: attention {counted} per replayed "
             f"step, expected {per_step}")
    prof = profile_calls(torch, dispatch, GRAPH_K)
    result = {"losses_graph": losses.tolist(),
              "losses_eager": [v.tolist() for v in eager],
              **checked, "captures": step_k.captures,
              "capture_s": step_k.capture_s, "replays": step_k.replays,
              "pool_mb": step_k.pool_mb,
              "wall_ms_per_step": wall_ms,
              "device_ms_per_step": None if prof is None
              else prof["device_ms"],
              "device_kernels_per_step": None if prof is None
              else prof["kernels"],
              "device_idle_share": None if prof is None
              else 1.0 - prof["device_ms"] / wall_ms,
              "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    del step_k, state, stacked, start
    torch.cuda.empty_cache()
    return result


def overfit(torch, dev, sd, work: Path) -> list[float]:
    """OVERFIT_STEPS bf16 steps (no augmentation, dropout 0, lr 1e-3) of
    the seeded model on one batch of the train split: the AU loss of
    each."""
    from auformer_torch import train_lib
    from auformer_torch.core.config import parse_opt
    from auformer_torch.core.weights import load_weights
    from auformer_torch.data import (Aff2CompDataset, DataLoader,
                                     SubsetSequentialSampler)
    from auformer_torch.nn import build_model, loss_suite
    from auformer_torch.parallel import step as tstep
    cfg = parse_opt(train_argv(work, "exp_overfit", "--dropout_rate", "0",
                               "--learning_rate", "1e-3"))
    cfg.device_augment = False
    model = build_model(cfg, dtype=torch.float32)
    load_weights(model, sd)
    model.to(dev)
    ds = Aff2CompDataset(cfg)
    ds.set_modes(list(model.modes))
    ids = np.nonzero(ds.train_ids)[0][:TRAIN_BATCH]
    batch = next(iter(DataLoader(ds, TRAIN_BATCH,
                                 SubsetSequentialSampler(ids))))
    batch = train_lib.to_device(batch, train_lib.device_batch_keys(
        model, cfg), dev)
    state = tstep.create_train_state(cfg, model)
    step = tstep.make_train_step(cfg, model, loss_suite(model))
    gen = torch.Generator(dev).manual_seed(SEED)
    return [float(step(state, batch, gen)["loss"])
            for _ in range(OVERFIT_STEPS)]


class feed_probe:
    """While active: the JPEG decodes (keys handed to the native reader's
    ``decode_batch``), the host-to-device bytes (``train_lib.to_device``),
    a copy of the first batch uploaded, the wav arena built, the decodes
    and bytes when ``evaluate`` starts (the train loop's share), and the
    K-step dispatch ``make_multi_train_step`` made (``--steps_per_dispatch
    K``). Instrumentation of this script; the port is untouched."""

    def __init__(self):
        from auformer_torch import train_lib
        from auformer_torch.data.native import NativeFrameStore
        self.lib, self.store = train_lib, NativeFrameStore

    def __enter__(self):
        self.decodes = self.h2d_bytes = 0
        self.first = self.plan = self.before_eval = self.multi = None
        lib = self.lib
        self.saved = (lib.to_device, lib.evaluate, lib.build_wav_arena,
                      lib.make_multi_train_step, self.store.decode_batch)
        to_device, evaluate, build, make_multi, decode = self.saved

        def decode_batch(reader, keys, *args, **kw):
            self.decodes += sum(1 for k in keys if k)
            return decode(reader, keys, *args, **kw)

        def upload(batch, keys, device):
            out = to_device(batch, keys, device)
            self.h2d_bytes += sum(v.numel() * v.element_size()
                                  for v in out.values())
            if self.first is None:
                self.first = {k: v.clone() for k, v in out.items()}
            return out

        def evaluate_(*args, **kw):
            if self.before_eval is None:
                self.before_eval = (self.decodes, self.h2d_bytes)
            return evaluate(*args, **kw)

        def build_wav_arena(*args, **kw):
            self.plan = build(*args, **kw)
            return self.plan

        def make_multi_train_step(*args, **kw):
            self.multi = make_multi(*args, **kw)
            return self.multi
        lib.to_device, lib.evaluate = upload, evaluate_
        lib.build_wav_arena = build_wav_arena
        lib.make_multi_train_step = make_multi_train_step
        self.store.decode_batch = decode_batch
        return self

    def __exit__(self, *exc):
        (self.lib.to_device, self.lib.evaluate, self.lib.build_wav_arena,
         self.lib.make_multi_train_step, self.store.decode_batch) = self.saved


def feed_run(torch, work: Path, exp: str, *flags,
             device_augment: bool = True) -> tuple[dict, dict, object]:
    """One epoch (or as many as ``flags`` say) of ``train.main`` at B=64 in
    bf16 with ``flags``, --device_augment unless ``device_augment`` is
    False (then the loader augments on the host), its counts set to 0 just
    before it: the attention launches (checked), the first epoch's
    clips/s, StepTimer means (and each epoch's), JPEG decodes and
    host-to-device bytes per train batch, arena MB, peak memory, under
    --steps_per_dispatch the graph's captures, replays and pool; and the
    first batch uploaded and the arena."""
    from auformer_torch import train
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend
    torch.cuda.reset_peak_memory_stats()
    fused_attention.launches = fused_attention.backward_calls = 0
    mel_frontend.launches = 0
    with feed_probe() as probe:
        t0 = time.perf_counter()
        _, history = train.main(train_argv(work, exp, "--epochs", "1",
                                           *flags,
                                           device_augment=device_augment))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {"attention": fused_attention.launches,
                "mel": mel_frontend.launches}
    backward = fused_attention.backward_calls
    h = history[0]
    steps = sum(e["steps"] for e in history)
    want = {"attention": ATTN_FWD_PER_STEP * (steps + len(history)),
            "mel": 0}
    if (launches != want or backward != ATTN_BWD_PER_STEP * steps
            or not all(np.isfinite(e["loss"]) for e in history)):
        fail(f"feed {flags}: {steps} steps, losses "
             f"{[e['loss'] for e in history]}, launches {launches} "
             f"(expected {want}), backward calls {backward}")
    steps = h["steps"]
    decodes, h2d = probe.before_eval
    multi = probe.multi
    graph = None if multi is None else {
        "captures": multi.captures, "capture_s": multi.capture_s,
        "replays": multi.replays, "pool_mb": multi.pool_mb,
        "launches_per_graphed_step": dict(zip(
            ("attention", "attention_backward", "mel"),
            multi.captured_counts))}
    return {"flags": list(flags), "device_augment": device_augment,
            "seconds": seconds, "steps": steps,
            "clips_per_s": steps * TRAIN_BATCH / h["seconds"],
            "step_timer_ms": {"data": h["data_ms"], "step": h["step_ms"]},
            "jpeg_decodes_per_batch": decodes / steps,
            "h2d_bytes_per_batch": h2d / steps,
            "arena_mb": (None if probe.plan is None
                         else probe.plan.nbytes / 2 ** 20),
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "epoch_s": h["seconds"], "eval_s": h["eval_seconds"],
            "loss": h["loss"], "launches": launches,
            "backward_calls": backward, "graph": graph,
            "epochs": [{"clips_per_s": e["steps"] * TRAIN_BATCH
                        / e["seconds"], "steps": e["steps"],
                        "step_timer_ms": {"data": e["data_ms"],
                                          "step": e["step_ms"]},
                        "loss": e["loss"]} for e in history]}, \
        probe.first, probe.plan


def trace_stats(trace: dict, steps: int) -> dict:
    """Per step of a Chrome trace of ``steps`` train steps: the window's
    wall ms, the card's busy ms (the union of its kernels, copies and
    sets), its kernels, the host-to-device copies (ms, MB), the host's
    CUDA runtime calls (ms, calls: the dispatch, and the same by call
    name: a synchronize's ms is the host waiting for the card); and the
    attention kernel's events in all."""
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = sorted((e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    busy, end = 0.0, -np.inf
    for e in device:
        stop = e["ts"] + e["dur"]
        busy += max(stop - max(e["ts"], end), 0.0)
        end = max(end, stop)
    wall = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    kernels = [e for e in device if e["cat"] == "kernel"]
    h2d = [e for e in device if e["cat"] == "gpu_memcpy"
           and "HtoD" in e["name"]]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    by_name: dict = {}
    for e in runtime:
        ms, calls = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "wall_ms_per_step": wall / 1e3 / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "device_idle_share": 1.0 - busy / wall,
        "kernels_per_step": len(kernels) / steps,
        "h2d_ms_per_step": sum(e["dur"] for e in h2d) / 1e3 / steps,
        "h2d_mb_per_step": sum(e.get("args", {}).get("bytes", 0)
                               for e in h2d) / 2 ** 20 / steps,
        "cuda_runtime_ms_per_step": sum(e["dur"] for e in runtime)
        / 1e3 / steps,
        "cuda_runtime_calls_per_step": len(runtime) / steps,
        "cuda_runtime_by_name_per_step": {
            name: {"ms": ms / steps, "calls": calls / steps}
            for name, (ms, calls) in top},
        "attention_kernel_events": sum(
            1 for e in kernels
            if "attention_" in e["name"] and "_kernel" in e["name"])}


def trace_run(torch, work: Path, k: int = 1) -> dict:
    """``--profile_dir`` on the dedup + arena feed for TRACE_STEPS steps at
    ``--steps_per_dispatch k``: train_lib must write one trace (steps 10-15
    at k = 1, ``train_lib.profile_window(k)``) that holds the attention
    kernel's events (at k > 1 from the graph's replays). A session whose
    device activity CUPTI lost is run again, up to PROFILER_SESSIONS
    times; then the run fails."""
    from auformer_torch import train_lib
    from auformer_torch.core.config import parse_opt
    first, last = train_lib.profile_window(k)
    for attempt in range(PROFILER_SESSIONS):
        trace_dir = work / f"trace_k{k}_{attempt}"
        cfg = parse_opt(train_argv(
            work, f"exp_feed_trace_k{k}", "--epochs", "1", "--frame_dedup",
            "--device_audio", "--locality_run", str(FEED_RUN),
            "--steps_per_dispatch", str(k), "--profile_dir", str(trace_dir)))
        _, history = train_lib.train(cfg, max_steps_per_epoch=TRACE_STEPS)
        files = sorted(trace_dir.glob("trace_*.json"))
        if history[0]["steps"] != TRACE_STEPS or len(files) != 1:
            fail(f"--profile_dir over {history[0]['steps']} steps wrote "
                 f"{files}")
        stats = trace_stats(json.loads(files[0].read_text()), last - first)
        PROFILER_LOG["sessions"] += 1
        if stats["attention_kernel_events"] > 0:
            return {**stats, "steps_per_dispatch": k,
                    "window": [first, last], "sessions": attempt + 1,
                    "trace_mb": files[0].stat().st_size / 2 ** 20}
        PROFILER_LOG["sessions_without_device_time"] += 1
    fail(f"{PROFILER_SESSIONS} --profile_dir traces held no attention "
         "kernel event")


def phase_feed(torch, dev, work: Path, sd: dict) -> dict:
    """The training feed on the train split, one epoch each at B=64, bf16,
    --device_augment: (a) dense with raw windows (--device_audio
    --audio_arena_mb 0) and (b) --frame_dedup with the default wav arena,
    both --locality_run FEED_RUN (the same batches), and (c) the default
    shuffled sampler, dense, with raw windows. Checks on the card: (b)'s
    first batch expanded and gathered equals (a)'s (clips and windows,
    torch.equal), one fp32 step from one state through both feeds gives
    one loss (FEED_LOSS_RTOL), the attention launches of every run, and a
    --profile_dir trace with the attention kernel's events. Returns (b):
    its launches are the slice's main path's."""
    from auformer_torch.core.config import parse_opt
    from auformer_torch.core.weights import load_weights
    from auformer_torch.nn import build_model, loss_suite
    from auformer_torch.parallel import step as tstep
    t_phase = time.perf_counter()
    locality = ("--locality_run", str(FEED_RUN))
    dense, first_a, _ = feed_run(torch, work, "exp_feed_dense",
                                 "--device_audio", "--audio_arena_mb", "0",
                                 *locality)
    fed, first_b, plan = feed_run(torch, work, "exp_feed_dedup",
                                  "--frame_dedup", "--device_audio",
                                  *locality)
    shuffled, _, _ = feed_run(torch, work, "exp_feed_shuffled",
                              "--device_audio", "--audio_arena_mb", "0")
    if plan is None or "frames" not in first_b:
        fail("the dedup + arena run built no arena or sent no frame pool")
    arena = torch.from_numpy(plan.arena).to(dev)
    same = {
        "clips": torch.equal(tstep.expand_dedup_batch(first_b)["clip"],
                             first_a["clip"]),
        "windows": torch.equal(
            tstep.gather_arena_windows(arena, first_b["audio_ofs"],
                                       first_b["audio_len"],
                                       plan.sample_len),
            first_a["audio"][:, 0, :]),
        "audio_len": torch.equal(first_b["audio_len"], first_a["audio_len"]),
        "labels": all(torch.equal(first_b[k], first_a[k])
                      for k in ("AU", "EX", "VA"))}
    if not all(same.values()):
        fail(f"the first dedup + arena batch differs from the dense one: "
             f"{same}")

    cfg32 = parse_opt(train_argv(work, "exp_feed_fp32", "--device_audio",
                                 "--compute_dtype", "float32"))
    losses = {}
    for name, batch, arg in (("dense", first_a, None),
                             ("dedup_arena", first_b, arena)):
        model = build_model(cfg32, dtype=torch.float32)
        load_weights(model, sd)
        model.to(dev)
        state = tstep.create_train_state(cfg32, model)
        step = tstep.make_train_step(cfg32, model, loss_suite(model))
        losses[name] = float(step(state, batch,
                                  torch.Generator(dev).manual_seed(SEED),
                                  arg)["loss"])
        del model, state, step
    rel = abs(losses["dedup_arena"] - losses["dense"]) / abs(losses["dense"])
    if not rel <= FEED_LOSS_RTOL:
        fail(f"fp32 step losses through the two feeds: {losses}")
    del first_a, first_b, arena
    torch.cuda.empty_cache()
    trace = trace_run(torch, work)
    emit("feed", nvidia_smi=nvidia_smi(), batch=TRAIN_BATCH,
         locality_run=FEED_RUN,
         runs={"dense_raw_windows": dense, "dedup_arena": fed,
               "shuffled_raw_windows": shuffled},
         first_batch_equal=same, fp32_step_loss=losses,
         fp32_step_loss_rel=rel, profile_dir_trace=trace,
         phase_s=time.perf_counter() - t_phase)
    return fed


def host_augment_cpu(work: Path) -> dict:
    """The port's host AutoAugment on this machine's CPU: its digest
    against PIL's (PIL_DIGEST); ``train_augment``'s ms per (64, 16) batch
    of the train split's 112x112 clips in one thread; and the loader's ms
    per batch of 64 clips (no audio) at HOST_AUG_THREADS[-1] threads,
    plain, augmenting in its threads, and through an AugmentPool of as
    many processes (each from a fresh dataset, so none finds another's
    frames in the decode cache; HOST_AUG_BATCHES batches timed after one
    that starts the reader)."""
    from auformer_torch.core.config import parse_opt
    from auformer_torch.data import (Aff2CompDataset, DataLoader,
                                     SubsetSequentialSampler)
    from auformer_torch.data import transforms
    t0 = time.perf_counter()
    digest = transforms.augment_digest()
    digest_s = time.perf_counter() - t0
    if digest != PIL_DIGEST:
        fail(f"train_augment's digest {digest} is not PIL's {PIL_DIGEST}")
    cfg = parse_opt(train_argv(work, "exp_host_cpu", device_augment=False))
    ds = Aff2CompDataset(cfg)
    ids = np.nonzero(ds.train_ids)[0]
    clips = [ds.get_clip(int(i)) for i in ids[:TRAIN_BATCH]]
    one_thread = []
    for rep in range(3):
        work_clips = [c.copy() for c in clips]
        t0 = time.perf_counter()
        for j, clip in enumerate(work_clips):
            transforms.train_augment(clip, random.Random((rep << 32) ^ j))
        one_thread.append((time.perf_counter() - t0) * 1e3)
    threads = HOST_AUG_THREADS[-1]
    pool = transforms.AugmentPool(threads, TRAIN_BATCH, ds.clip_bytes)
    loader_ms = {}
    try:
        for name, aug, augment_pool in (("plain", False, None),
                                        ("augment_in_threads", True, None),
                                        ("augment_in_pool", True, pool)):
            ds = Aff2CompDataset(cfg)
            ds.set_modes(["clip"])
            ds.set_aug(aug, augment_pool)
            ds.aug_seed = SEED
            batches = iter(DataLoader(ds, TRAIN_BATCH, SubsetSequentialSampler(
                ids[:TRAIN_BATCH * (HOST_AUG_BATCHES + 1)]),
                num_threads=threads, drop_last=True))
            next(batches)
            t0 = time.perf_counter()
            n = sum(1 for _ in batches)
            loader_ms[name] = (time.perf_counter() - t0) * 1e3 / n
    finally:
        pool.close()
    return {"digest": digest, "digest_equals_pil": True,
            "digest_s": digest_s, "cpu_count": os.cpu_count(),
            "train_augment_ms_per_batch_one_thread": one_thread,
            f"loader_ms_per_batch_threads{threads}": loader_ms}


class in_thread_augment:
    """While active, train_lib makes no AugmentPool: the dataset augments
    each clip in the loader thread that loads it, as the loop would run
    without the pool. Instrumentation of this script; the port is
    untouched."""

    def __init__(self):
        from auformer_torch import train_lib
        self.lib = train_lib

    def __enter__(self):
        self.saved = self.lib.AugmentPool
        self.lib.AugmentPool = lambda *args: None
        return self

    def __exit__(self, *exc):
        self.lib.AugmentPool = self.saved


def in_thread_run(torch, work: Path, flags: tuple) -> dict:
    """HOST_AUG_IN_THREAD_STEPS steps of (h) with the augmentation in the
    loader's threads (``in_thread_augment``): StepTimer data and step ms,
    clips/s of the capped epoch."""
    from auformer_torch import train_lib
    from auformer_torch.core.config import parse_opt
    cfg = parse_opt(train_argv(work, "exp_host_in_thread", "--epochs", "1",
                               *flags, device_augment=False))
    with in_thread_augment():
        _, history = train_lib.train(
            cfg, max_steps_per_epoch=HOST_AUG_IN_THREAD_STEPS)
    h = history[0]
    return {"steps": h["steps"],
            "clips_per_s": h["steps"] * TRAIN_BATCH / h["seconds"],
            "step_timer_ms": {"data": h["data_ms"], "step": h["step_ms"]},
            "loss": h["loss"]}


def first_batch_threads(torch, work: Path, flags: tuple, first: dict
                        ) -> dict:
    """One step of train_lib.train with host augmentation at
    --host_threads HOST_AUG_THREADS[0]: its first uploaded batch must
    equal ``first``, the (h) run's at HOST_AUG_THREADS[-1] threads
    (``flags``; torch.equal, every entry)."""
    from auformer_torch import train_lib
    from auformer_torch.core.config import parse_opt
    cfg = parse_opt(train_argv(
        work, "exp_host_threads", "--epochs", "1", *flags, "--host_threads",
        str(HOST_AUG_THREADS[0]), device_augment=False))
    with feed_probe() as probe:
        train_lib.train(cfg, max_steps_per_epoch=1)
    same = {k: (k in probe.first and torch.equal(probe.first[k], v))
            for k, v in first.items()}
    if set(probe.first) != set(first) or not all(same.values()):
        fail(f"the first host-augmented batch at {HOST_AUG_THREADS} loader "
             f"threads differs: {same}")
    return {"threads": list(HOST_AUG_THREADS), "equal": same}


def phase_host_aug(torch, dev, work: Path) -> dict:
    """avformer's train.main at B=64, bf16, full width, one epoch of the
    train split with --device_audio --locality_run FEED_RUN (dense clips,
    the default wav arena, K = 1), twice: (h) the loader augments each
    clip on the host, in an AugmentPool's processes (no --device_augment:
    the slice's main path, its counts set to 0 just before it) and (d)
    --device_augment. Per run clips/s, StepTimer data and step ms,
    attention launches (checked: 11 per step and per eval step) and
    backward calls (3 per step), peak memory. Then (h)'s first batch at 1
    and 4 loader threads, HOST_AUG_IN_THREAD_STEPS steps of (h) with the
    augmentation in the loader's threads instead, and the CPU's numbers
    (``host_augment_cpu``). Returns (h)."""
    t_phase = time.perf_counter()
    flags = ("--device_audio", "--locality_run", str(FEED_RUN),
             "--host_threads", str(HOST_AUG_THREADS[-1]))
    host, first, _ = feed_run(torch, work, "exp_host_aug", *flags,
                              device_augment=False)
    device, _, _ = feed_run(torch, work, "exp_device_aug", *flags)
    threads = first_batch_threads(torch, work, flags, first)
    del first
    in_thread = in_thread_run(torch, work, flags)
    torch.cuda.empty_cache()
    emit("host_aug", nvidia_smi=nvidia_smi(), batch=TRAIN_BATCH,
         locality_run=FEED_RUN, runs={"host": host, "device": device,
                                      "host_in_loader_threads": in_thread},
         first_batch_threads=threads, cpu=host_augment_cpu(work),
         phase_s=time.perf_counter() - t_phase)
    return host


def train_tensors(state) -> dict:
    """Every parameter and BatchNorm statistic of the state's model, and
    Adam's moments and step counts."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            out[f"adam.{i}.{name}"] = s[name].detach().clone()
    return out


def k_step_run(torch, cfg, model, start: dict, batches: list, seeds: list,
               k: int | None = None, mesh=None) -> tuple:
    """From the weights ``start``, loaded into ``model``, with a fresh
    capturable Adam: the steps of ``batches`` (device batches) with
    ``seeds``, as dispatches of ``make_multi_train_step(k)`` or (k None)
    eager single steps, data parallel under ``mesh``. -> (losses,
    train_tensors, step_k, state)."""
    from auformer_torch.nn import loss_suite
    from auformer_torch.parallel import step as tstep
    model.load_state_dict(start)
    state = tstep.create_train_state(cfg, model, capturable=True)
    if k is None:
        step = tstep.make_train_step(cfg, model, loss_suite(model), mesh)
        gen = torch.Generator(next(model.parameters()).device)
        losses = torch.stack([step(state, b, gen.manual_seed(s))["loss"]
                              for b, s in zip(batches, seeds)])
        return losses, train_tensors(state), None, state
    step_k = tstep.make_multi_train_step(cfg, model, loss_suite(model), k,
                                         mesh)
    losses = []
    for d in range(0, len(batches), k):
        stacked = {key: torch.stack([b[key] for b in batches[d:d + k]])
                   for key in batches[0]}
        losses.append(step_k(state, stacked, seeds[d:d + k])["loss"])
    return torch.cat(losses), train_tensors(state), step_k, state


class deterministic:
    """While active: cuDNN's deterministic algorithms and PyTorch's
    deterministic implementations (a warning, not an error, for an op
    without one), so that two eager runs of the same steps agree bit for
    bit where they can. Without them a model that trains its convolutions
    differs run to run (cuDNN's weight-gradient atomics), and 4 steps of
    Adam amplify that past any fixed bound (vformer at 32x32 on an H100:
    1.4e-2 in the loss, graph against eager, beside 3.8e-3 between two
    eager runs)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        torch = self.torch
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark,
                      torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        torch = self.torch
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         on, warn_only) = self.saved
        torch.use_deterministic_algorithms(on, warn_only=warn_only)


def graph_against_eager(torch, what: str, got: dict, want: dict,
                        other: dict) -> dict:
    """The graph's tensors ``got`` against an eager run's ``want``: equal
    bit for bit wherever two eager runs (``want``, ``other``) are, else
    within twice their spread; fails otherwise."""
    counts = {"tensors": len(want), "bitwise_in_eager": 0,
              "max_eager_spread": 0.0, "max_abs_diff": 0.0}
    for key, value in want.items():
        spread = (value.double() - other[key].double()).abs().max().item()
        diff = (got[key].double() - value.double()).abs().max().item()
        counts["max_eager_spread"] = max(counts["max_eager_spread"], spread)
        counts["max_abs_diff"] = max(counts["max_abs_diff"], diff)
        if spread == 0:
            counts["bitwise_in_eager"] += 1
            if not torch.equal(got[key], value):
                fail(f"{what}: the graph's {key} differs by {diff} where two "
                     f"eager runs agree bit for bit")
        elif diff > 2 * spread:
            fail(f"{what}: the graph's {key} differs by {diff}, twice the "
                 f"eager runs' spread is {2 * spread}")
    return counts


def graph_check(torch, dev, name: str, weights: dict) -> dict:
    """fp32, full width, B=64, --device_augment, dropout on: GRAPH_STEPS
    steps as dispatches of GRAPH_K through ``make_multi_train_step`` (the
    warm-up, then a capture and its replays) against the same steps eager
    from the same weights and seeds (twice, for their spread), all with
    the capturable Adam: losses, every parameter and BatchNorm statistic,
    Adam's moments."""
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.nn import build_model
    modality = {"avformer": "A;V", "vformer": "V"}[name]
    cfg = Config(model_name=name, modality=modality, task="AU",
                 compute_dtype="float32", image_size=IMAGE, n_frames=FRAMES,
                 batch_size=TRAIN_BATCH, device_augment=True)
    model = build_model(cfg, dtype=torch.float32)
    load_weights(model, weights)
    model.to(dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(SEED + 11)
    batches = [on(torch, train_batch(rs, TRAIN_BATCH), dev)
               for _ in range(GRAPH_STEPS)]
    seeds = [SEED + 100 + i for i in range(GRAPH_STEPS)]
    with deterministic(torch):
        eager = [k_step_run(torch, cfg, model, start, batches, seeds)
                 for _ in range(2)]
        losses, got, step_k, _ = k_step_run(torch, cfg, model, start,
                                            batches, seeds, k=GRAPH_K)
    (want_loss, want, _, _), (other_loss, other, _, _) = eager
    checked = graph_against_eager(
        torch, f"{name} fp32", {"loss": losses, **got},
        {"loss": want_loss, **want}, {"loss": other_loss, **other})
    result = {"losses_graph": losses.tolist(),
              "losses_eager": [want_loss.tolist(), other_loss.tolist()],
              "captures": step_k.captures, "capture_s": step_k.capture_s,
              "replays": step_k.replays, "pool_mb": step_k.pool_mb,
              "launches_per_graphed_step": dict(zip(
                  ("attention", "attention_backward", "mel"),
                  step_k.captured_counts)), **checked}
    del model, step_k, batches, eager, got, start
    torch.cuda.empty_cache()
    return result


def capture_failure_check(torch, dev) -> dict:
    """A host sync (``float(loss)``) put into the step after the warm-up
    dispatch (vformer, 32x32, B=4): the next dispatch must raise from the
    capture, and no step may run in its place (the step count and the
    weights stay)."""
    from auformer_torch.core.config import Config
    from auformer_torch.nn import build_model
    from auformer_torch.parallel import step as tstep
    cfg = Config(model_name="vformer", modality="V", task="AU",
                 compute_dtype="float32", image_size=32, n_frames=4,
                 batch_size=4, device_augment=True)
    model = build_model(cfg).to(dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(SEED + 12)
    batches = [on(torch, zoo_step_batch(rs, "vformer", "V", 4, 32, 4), dev)
               for _ in range(2 * GRAPH_K)]
    seeds = list(range(2 * GRAPH_K))
    _, _, step_k, state = k_step_run(torch, cfg, model, start,
                                     batches[:GRAPH_K], seeds[:GRAPH_K],
                                     k=GRAPH_K)
    task_loss = tstep.task_loss

    def syncing(*args, **kw):
        loss, parts = task_loss(*args, **kw)
        float(loss)
        return loss, parts
    before = {k: v.clone() for k, v in model.state_dict().items()}
    stacked = {key: torch.stack([b[key] for b in batches[GRAPH_K:]])
               for key in batches[0]}
    tstep.task_loss = syncing
    try:
        step_k(state, stacked, seeds[GRAPH_K:])
        raised = None
    except RuntimeError as e:
        raised = str(e)
    finally:
        tstep.task_loss = task_loss
    torch.cuda.synchronize()
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])]
    if (raised is None or "capturing the train step" not in raised
            or step_k.graph is not None or state.step != GRAPH_K or moved):
        fail(f"a host sync in the step: raised {raised!r}, graph "
             f"{step_k.graph}, {state.step} steps, moved {moved[:3]}")
    return {"raised": raised[:300], "steps_after": state.step}


def phase_graph(torch, dev, work: Path, sd: dict, fed: dict) -> dict:
    """The graph sub-phase (``--steps_per_dispatch K``, a CUDA graph of the
    step): the fp32 checks of avformer and vformer, two epochs of the fed
    loop (``feed`` (b)'s flags) at K = FEED_GRAPH_K beside (b)'s K = 1
    numbers, its --profile_dir trace, and a capture that must fail. The
    zoo's graphed dispatches run in ``zoo_train_steps``."""
    from auformer_torch.core.config import Config
    from auformer_torch.nn import build_model
    t_phase = time.perf_counter()
    checks = {"avformer": graph_check(torch, dev, "avformer", sd)}
    vf_sd = random_reference_state_dict(build_model(Config(
        model_name="vformer", modality="V", compute_dtype="float32")),
        SEED + 3)
    checks["vformer"] = graph_check(torch, dev, "vformer", vf_sd)
    # two epochs: the first holds the warm-up and the capture, the
    # second only replays and the sub-K tail
    graphed, _, _ = feed_run(torch, work, "exp_feed_graph", "--frame_dedup",
                             "--device_audio", "--locality_run",
                             str(FEED_RUN), "--steps_per_dispatch",
                             str(FEED_GRAPH_K), "--epochs", "2")
    if graphed["graph"] is None or graphed["graph"]["captures"] != 1:
        fail(f"--steps_per_dispatch {FEED_GRAPH_K}: {graphed['graph']}")
    torch.cuda.empty_cache()
    trace = trace_run(torch, work, FEED_GRAPH_K)
    failure = capture_failure_check(torch, dev)
    keys = ("clips_per_s", "step_timer_ms", "peak_memory_mb", "loss",
            "launches", "backward_calls", "steps", "epoch_s", "graph",
            "epochs")
    return {"fp32_graph_vs_eager": checks,
            "fed_loop": {"k1": {key: fed.get(key) for key in keys},
                         f"k{FEED_GRAPH_K}": {key: graphed[key]
                                              for key in keys}},
            "profile_dir_trace": trace, "capture_failure": failure,
            "launches": graphed["launches"],
            "phase_s": time.perf_counter() - t_phase}


def dp_records(torch, state) -> dict:
    """name -> the first Adam moment of each trainable parameter and every
    floating buffer (BatchNorm statistics), on the host."""
    from auformer_torch.parallel.multiproc import step_record
    return step_record(state, state.model)


def rows_over_tol(got: np.ndarray, want: np.ndarray) -> float:
    """The worst (|got - want| - rtol |want|) / atol of two fp32 row
    blocks from the same forward at other batch splits, at the full
    forward's SLICE_TOL: <= 1 holds."""
    rtol, atol = SLICE_TOL
    return float(((np.abs(got - want) - rtol * np.abs(want)) / atol).max())


def dp_compare(got: dict, want: dict) -> dict:
    """A data-parallel step's record against the world-1 step's: the loss
    (relative), the first Adam moments (the worst (|diff| - rtol |want|)
    / atol, <= 1 within DP_GRAD_TOL) and the BatchNorm statistics (abs),
    at tests/test_parallel.py's tolerances; fails past them."""
    rtol, atol = DP_GRAD_TOL
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    grad = max(float((np.abs(got[k] - v) - rtol * np.abs(v)).max()) / atol
               for k, v in want.items() if k.startswith("g/"))
    stats = max(float(np.abs(got[k] - v).max())
                for k, v in want.items() if k.startswith("s/"))
    out = {"loss": got["loss"], "loss_want": want["loss"],
           "loss_rel_err": loss_rel, "loss_rel_tol": DP_LOSS_REL,
           "grad_err_over_tol": grad, "grad_tol": list(DP_GRAD_TOL),
           "stats_max_abs_err": stats, "stats_tol": DP_STATS_ATOL,
           "tensors": sum(k[:2] in ("g/", "s/") for k in want)}
    if not (loss_rel <= DP_LOSS_REL and grad <= 1.0
            and stats < DP_STATS_ATOL):
        fail(f"data-parallel step against world 1: {out}")
    return out


class draw_world:
    """Stands for rank 0 of a world of ``world`` where only the random
    draws look at the mesh (``core.mesh.draw_rows``)."""

    def __init__(self, world: int):
        self.rank, self.world = 0, world


def draw_cost(torch, dev, model, cfg, batch: dict) -> dict:
    """The step's random draws at a local batch of DP_DRAW_LOCAL rows: the
    AutoAugment's and the flip's draws and one mask at each dropout site
    (its shapes from one train-mode forward), drawn for the local rows
    (world 1) and for a global batch of DP_DRAW_WORLD x as many (rank 0
    of a world of DP_DRAW_WORLD keeps its rows); CUDA-event ms per step."""
    from auformer_torch.core.mesh import draw_rows
    from auformer_torch.nn.blocks import Dropout, set_dropout_generator
    from auformer_torch.ops.augment_device import policy_draws
    from auformer_torch.parallel import step as tstep
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape)))
        for m in model.modules() if isinstance(m, Dropout) and m.p > 0]
    gen = torch.Generator(dev).manual_seed(SEED)
    model.train()
    set_dropout_generator(model, gen)
    with torch.no_grad():
        tstep._forward(cfg, model, tstep.prep_batch(batch, train=False))
    set_dropout_generator(model, None)
    for h in hooks:
        h.remove()
    b, t = batch["clip"].shape[:2]

    def draws(mesh):
        def rand(s):
            return torch.rand(s, generator=gen, device=dev)
        policy_draws(b, t, gen, dev, mesh)
        draw_rows(rand, (b,), mesh)
        for s in shapes:
            draw_rows(rand, s, mesh)

    out = {"sites": len(shapes), "local_batch": b, "world": DP_DRAW_WORLD}
    for name, mesh in (("world1_ms", None),
                       (f"world{DP_DRAW_WORLD}_ms", draw_world(
                           DP_DRAW_WORLD))):
        for _ in range(3):
            draws(mesh)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            draws(mesh)
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / 20
    out["extra_ms_per_step"] = out[f"world{DP_DRAW_WORLD}_ms"] \
        - out["world1_ms"]
    return out


def step_overhead(torch, dev, mesh, weights: dict) -> dict:
    """The train phase's step on ready batches (avformer, bf16, B=64,
    --device_augment) without a process group and under the NCCL world of
    one, in turns (plain, mesh, mesh, plain, ...; DP_OVERHEAD_ROUNDS of
    DP_OVERHEAD_STEPS steps each after a warm-up): wall ms per step after
    a device sync."""
    from auformer_torch.core.config import Config
    from auformer_torch.nn import build_model, loss_suite
    from auformer_torch.parallel import step as tstep
    cfg = Config(model_name="avformer", modality="A;V", task="AU",
                 image_size=IMAGE, n_frames=FRAMES, batch_size=TRAIN_BATCH,
                 device_augment=True)
    model = build_model(cfg, dtype=torch.float32)
    model.load_state_dict(weights)
    model.to(dev)
    state = tstep.create_train_state(cfg, model)
    rs = np.random.RandomState(SEED + 13)
    batch = on(torch, train_batch(rs, TRAIN_BATCH), dev)
    steps = {"plain": tstep.make_train_step(cfg, model, loss_suite(model)),
             "mesh": tstep.make_train_step(cfg, model, loss_suite(model),
                                           mesh)}
    gen = torch.Generator(dev)
    times = {"plain": [], "mesh": []}
    for name in ("plain", "mesh"):
        for i in range(2):
            steps[name](state, batch, gen.manual_seed(i))
    order = ["plain", "mesh", "mesh", "plain"] * (DP_OVERHEAD_ROUNDS // 4)
    for r, name in enumerate(order):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DP_OVERHEAD_STEPS):
            steps[name](state, batch, gen.manual_seed(r * 100 + i))
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3
                           / DP_OVERHEAD_STEPS)
    del model, state, batch
    torch.cuda.empty_cache()
    med = {k: float(np.median(v)) for k, v in times.items()}
    return {"batch": TRAIN_BATCH, "dtype": "bfloat16", "ms_per_step": times,
            "median_ms": med, "overhead_ms": med["mesh"] - med["plain"]}


def dp_worker(out_path: str, work: str) -> int:
    """The ``dp`` sub-phase's NCCL world of one (started by
    ``torch.distributed.run --nproc_per_node 1``): the fp32 step under the
    mesh against the step without one, K = DP_GRAPH_K with the collectives
    captured against eager, the collectives per step, the draws' cost, then
    ``train.main`` at B=64 in bf16 with --device_augment for an epoch of
    the train split (the data-parallel main path, its counts set to 0 just
    before it). Writes its numbers to ``out_path``; any failed check exits
    non-zero."""
    import torch
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from auformer_torch import train
    from auformer_torch.core.config import Config
    from auformer_torch.core.mesh import make_mesh, maybe_init_distributed
    from auformer_torch.core.weights import load_weights
    from auformer_torch.infer import resolve_device
    from auformer_torch.nn import build_model, loss_suite
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend
    from auformer_torch.parallel import step as tstep

    dev = resolve_device(None)
    t0 = time.perf_counter()
    if not maybe_init_distributed(dev):
        fail("dp worker: no torchrun environment")
    mesh = make_mesh("data:-1", dev)
    init_s = time.perf_counter() - t0
    if mesh.backend != "nccl" or mesh.world != 1:
        fail(f"dp worker: {mesh.backend} world {mesh.world}, not NCCL 1")
    work = Path(work)
    res = {"device": str(dev), "backend": mesh.backend, "world": mesh.world,
           "init_s": init_s}

    cfg = Config(model_name="avformer", modality="A;V", task="AU",
                 compute_dtype="float32", image_size=IMAGE, n_frames=FRAMES,
                 batch_size=DP_STEP_BATCH, device_augment=True)
    model = build_model(cfg, dtype=torch.float32)
    load_weights(model, random_reference_state_dict(
        build_model(Config(compute_dtype="float32")), SEED))
    model.to(dev)
    suite = loss_suite(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(SEED + 12)
    batch = on(torch, train_batch(rs, DP_STEP_BATCH), dev)
    recs = {}
    with deterministic(torch):
        for label, m in (("plain", None), ("mesh", mesh)):
            model.load_state_dict(start)
            state = tstep.create_train_state(cfg, model)
            before = dict(mesh.counts)
            metrics = tstep.make_train_step(cfg, model, suite, m)(
                state, batch, torch.Generator(dev).manual_seed(SEED + 5))
            recs[label] = {"loss": metrics["loss"].item(),
                           **dp_records(torch, state)}
            per_step = {k: v - before.get(k, 0)
                        for k, v in mesh.counts.items()
                        if v != before.get(k, 0)}
    res["fp32_step_vs_plain"] = dp_compare(recs["mesh"], recs["plain"])
    res["collectives_per_step"] = per_step
    res["draw_cost"] = draw_cost(torch, dev, model, cfg,
                                 on(torch, train_batch(rs, DP_DRAW_LOCAL),
                                    dev))
    res["step_overhead"] = step_overhead(torch, dev, mesh, start)

    batches = [on(torch, train_batch(rs, DP_STEP_BATCH), dev)
               for _ in range(DP_GRAPH_STEPS)]
    seeds = [SEED + 200 + i for i in range(DP_GRAPH_STEPS)]
    with deterministic(torch):
        eager = [k_step_run(torch, cfg, model, start, batches, seeds,
                            mesh=mesh) for _ in range(2)]
        losses, got, step_k, _ = k_step_run(torch, cfg, model, start,
                                            batches, seeds, k=DP_GRAPH_K,
                                            mesh=mesh)
    (want_loss, want, _, _), (other_loss, other, _, _) = eager
    checked = graph_against_eager(
        torch, "dp graph fp32", {"loss": losses, **got},
        {"loss": want_loss, **want}, {"loss": other_loss, **other})
    if step_k.captures != 1 or step_k.replays != DP_GRAPH_STEPS - DP_GRAPH_K:
        fail(f"dp graph: {step_k.captures} captures, {step_k.replays} "
             "replays")
    res["graph"] = {"k": DP_GRAPH_K, "steps": DP_GRAPH_STEPS,
                    "losses_graph": losses.tolist(),
                    "losses_eager": want_loss.tolist(),
                    "captures": step_k.captures, "replays": step_k.replays,
                    "capture_s": step_k.capture_s,
                    "launches_per_graphed_step": dict(zip(
                        ("attention", "attention_backward", "mel"),
                        step_k.captured_counts)), **checked}
    del model, step_k, batches, eager, got, start, state
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    fused_attention.launches = fused_attention.backward_calls = 0
    mel_frontend.launches = 0
    t0 = time.perf_counter()
    _, history = train.main(train_argv(work, "exp_dp", "--epochs", "1"))
    torch.cuda.synchronize()
    launches = {"attention": fused_attention.launches,
                "mel": mel_frontend.launches}
    backward_calls = fused_attention.backward_calls
    steps = sum(h["steps"] for h in history)
    want = {"attention": ATTN_FWD_PER_STEP * (steps + len(history)),
            "mel": 0}
    if (len(history) != 1 or launches != want
            or backward_calls != ATTN_BWD_PER_STEP * steps
            or not all(np.isfinite(h["loss"]) for h in history)):
        fail(f"dp train.main: {len(history)} epochs, {steps} steps, "
             f"launches {launches} (expected {want}), backward calls "
             f"{backward_calls}, losses {[h['loss'] for h in history]}")
    h = history[0]
    res["main"] = {"seconds": time.perf_counter() - t0, "steps": steps,
                   "launches": launches, "backward_calls": backward_calls,
                   "loss": h["loss"], "score": h["score"],
                   "clips_per_s": h["steps"] * TRAIN_BATCH / h["seconds"],
                   "step_timer_ms": {"data": h["data_ms"],
                                     "step": h["step_ms"]},
                   "peak_memory_mb": torch.cuda.max_memory_allocated()
                   / 2 ** 20}
    Path(out_path).write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def phase_dp(torch, dev, work: Path, train_clips_per_s: list) -> dict:
    """The data-parallel sub-phase (its own line) on the one card: (a) an
    NCCL world of one in a process of ``torch.distributed.run``
    (``dp_worker``); (b) a gloo world of two processes sharing the card
    (``parallel/multiproc.py``, fp32, global B=DP_GLOO_BATCH), avformer and
    vformer, each rank's step and gathered eval rows against the world-1
    step on the global batch here, and the step ms (a test rig: gloo goes
    through the host and the two processes share one card); (c) in the
    same world, run_inference_sweep over two synthetic videos, one per
    rank, against world 1 here (rank 0 alone writes the files)."""
    from auformer_torch.infer import run_inference_sweep
    from auformer_torch.nn import build_model
    from auformer_torch.parallel import multiproc as mp
    t_phase = time.perf_counter()
    out = work / "dp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "1", "--master_addr", "127.0.0.1", "--master_port",
         str(mp.free_port()), str(ROOT / "chip_smoke.py"), "dp_worker",
         str(out / "nccl.json"), str(work)],
        cwd=ROOT, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    if proc.returncode != 0:
        fail(f"dp: the NCCL world of one exited with {proc.returncode}:\n"
             + (proc.stdout + proc.stderr)[-4000:])
    nccl = json.loads((out / "nccl.json").read_text())
    nccl["process_s"] = time.perf_counter() - t0
    nccl["main"]["clips_per_s_beside"] = {
        "train_phase_epochs_no_process_group": train_clips_per_s}

    t0 = time.perf_counter()
    mp.spawn_workers(str(out / "gloo"), 2, [
        "--backend", "gloo", "--device", str(dev), "--models",
        "avformer,vformer", "--image_size", str(IMAGE), "--n_frames",
        str(FRAMES), "--batch", str(DP_GLOO_BATCH), "--timed_steps",
        str(DP_TIMED_STEPS), "--serve", str(DP_SERVE_FRAMES)],
        timeout=DP_TIMEOUT_S)
    gloo = {"processes_s": time.perf_counter() - t0, "world": 2,
            "device": f"{dev} (both ranks)", "batch": DP_GLOO_BATCH}
    table = mp.make_global_table(DP_GLOO_BATCH, FRAMES, IMAGE, 0)
    for name in ("avformer", "vformer"):
        cfg = mp.model_config(name, image_size=IMAGE, n_frames=FRAMES,
                              batch_size=DP_GLOO_BATCH, dropout_rate=0.2,
                              device_augment=True)
        want = mp.world_one_step(cfg, table, dev)
        ranks = [dict(np.load(out / "gloo" / f"{name}_r{r}.npz"))
                 for r in range(2)]
        for r in ranks:
            r["loss"] = float(r["loss"])
        if not np.array_equal(ranks[0]["eval_rows"], ranks[1]["eval_rows"]):
            fail(f"dp gloo {name}: the ranks' gathered eval rows differ")
        rows_err = rows_over_tol(ranks[0]["eval_rows"], want["eval_rows"])
        if rows_err > 1.0 or ranks[0]["eval_rows"].shape != (
                DP_GLOO_BATCH, 21):
            fail(f"dp gloo {name}: eval rows {ranks[0]['eval_rows'].shape} "
                 f"{rows_err} from world 1")
        gloo[name] = {
            "ranks": [dp_compare(r, want) for r in ranks],
            "eval_rows": list(ranks[0]["eval_rows"].shape),
            "eval_rows_err_over_tol": rows_err, "rows_tol": list(SLICE_TOL),
            "step_ms_test_rig": [float(r["step_ms"]) for r in ranks],
            "collectives_per_step": str(ranks[0]["collectives"])}
        del want
        torch.cuda.empty_cache()

    cfg = mp.model_config("avformer", image_size=IMAGE, n_frames=FRAMES)
    torch.manual_seed(0)
    want = run_inference_sweep(cfg, build_model(cfg), mp.synthetic_videos(
        2, DP_SERVE_FRAMES, IMAGE, 0), str(out / "serve_world1"), device=dev)
    errs = [rows_over_tol(np.load(out / "gloo" / f"sweep_r{r}.npy"), want)
            for r in range(2)]
    files = sorted((out / "serve_world1" / "au").iterdir())
    same = [(out / "gloo" / "results_r0" / "au" / f.name).read_text()
            == f.read_text() for f in files]
    if max(errs) > 1.0 or not all(same) or len(same) != 2 \
            or (out / "gloo" / "results_r1").exists():
        fail(f"dp video-sharded sweep: {errs} from world 1, files equal "
             f"{same}, rank 1 wrote {(out / 'gloo' / 'results_r1').exists()}")
    serve = {"videos": [DP_SERVE_FRAMES, DP_SERVE_FRAMES + 7],
             "rows": int(want.shape[0]), "err_over_tol_vs_world1": errs,
             "tol": list(SLICE_TOL), "files_equal": len(same)}
    shutil.rmtree(out, ignore_errors=True)
    return {"nccl_world1": nccl, "gloo_world2": gloo,
            "video_sharded_sweep": serve,
            "launches": nccl["main"]["launches"],
            "phase_s": time.perf_counter() - t_phase}


def phase_train(torch, dev) -> tuple[dict, list, dict]:
    from auformer_torch import train, train_lib
    from auformer_torch.core.config import Config, parse_opt
    from auformer_torch.core.weights import (load_reference_state_dict,
                                             load_weights)
    from auformer_torch.data.fixtures import generate_synthetic_dataset
    from auformer_torch.nn import build_model
    from auformer_torch.ops.attention import fused_attention
    from auformer_torch.ops.audio_kernel import mel_frontend
    from auformer_torch.parallel import step as tstep

    t_phase = time.perf_counter()
    work = ROOT / ".cache" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    generate_synthetic_dataset(str(work / "root"), str(work / "labels"),
                               n_videos=len(TRAIN_FRAMES),
                               frames_per_video=TRAIN_FRAMES,
                               image_size=IMAGE, seed=SEED, with_masks=False,
                               splits=["train", "train", "val", "test"])
    fixture_s = time.perf_counter() - t0
    # the seconds of each part of the phase, for the line
    part_s, t_part = {}, [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now

    # before any training: the gradient checks
    grad_cases = attention_grad_cases(torch, dev)
    part("attention_gradient")
    sd = random_reference_state_dict(
        build_model(Config(compute_dtype="float32")), SEED)
    model_grads = model_gradient_check(torch, dev, sd)
    step_check = card_vs_cpu_step(torch, dev, sd)
    aug = augment_check(torch, dev)
    part("model_gradient_card_vs_cpu_step_augmentation")
    torch.cuda.empty_cache()

    # the main path: python -m auformer_torch.train, bf16, --device_augment,
    # 2 epochs, with the counts set to 0 just before it
    torch.cuda.reset_peak_memory_stats()
    fused_attention.launches = fused_attention.backward_calls = 0
    mel_frontend.launches = 0
    t0 = time.perf_counter()
    state, history = train.main(train_argv(work, "exp"))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"attention": fused_attention.launches,
                "mel": mel_frontend.launches}
    backward_calls = fused_attention.backward_calls
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    steps = sum(h["steps"] for h in history)
    want = {"attention": ATTN_FWD_PER_STEP * (steps + len(history)),
            "mel": 0}
    if (len(history) != 2 or launches != want
            or backward_calls != ATTN_BWD_PER_STEP * steps):
        fail(f"train.main: {len(history)} epochs, {steps} steps, launches "
             f"{launches} (expected {want}), backward calls "
             f"{backward_calls}")
    pretrain = work / "exp" / "pretrain"
    for h in history:
        if not (np.isfinite(h["loss"]) and np.isfinite(h["score"])
                and set(h["scores"]) == {"EX", "AU", "VA", "loss"}):
            fail(f"epoch {h['epoch']} has no finite loss and scores: {h}")
    if not (pretrain / "latest.pth").is_file():
        fail("train.main wrote no latest.pth")
    part("main")

    # 1 epoch with --resume, then the checkpoint round trip: latest.pth
    # into a fresh model against the trained model in memory, fp32 eval
    state, resumed = train.main(train_argv(
        work, "exp", "--resume", "--start_epoch", "2", "--epochs", "3"))
    if [h["epoch"] for h in resumed] != [2]:
        fail(f"--resume ran epochs {[h['epoch'] for h in resumed]}")
    cfg32 = Config(compute_dtype="float32", image_size=IMAGE,
                   n_frames=FRAMES)
    fresh = build_model(cfg32, dtype=torch.float32)
    load_weights(fresh, load_reference_state_dict(
        str(pretrain / "latest.pth")))
    fresh.to(dev).eval()
    batch = on(torch, train_batch(np.random.RandomState(SEED + 9), 8), dev)
    logits = []
    for model in (state.model.eval(), fresh):
        with torch.no_grad():
            logits.append(tstep._forward(cfg32, model, tstep.prep_batch(
                batch, train=False)))
    ckpt_err = (logits[0] - logits[1]).abs().max().item()
    if not (torch.isfinite(logits[0]).all() and ckpt_err <= 1e-5):
        fail(f"latest.pth reloaded gives logits {ckpt_err} from the trained "
             "model's")
    del fresh

    # 5 steps with --device_audio (raw windows, no arena)
    cfg_audio = parse_opt(train_argv(work, "exp_audio", "--device_audio",
                                     "--audio_arena_mb", "0", "--epochs",
                                     "1"))
    t0 = time.perf_counter()
    audio_state, audio_hist = train_lib.train(cfg_audio,
                                              max_steps_per_epoch=5)
    audio_s = time.perf_counter() - t0
    if audio_state.step != 5 or not np.isfinite(audio_hist[0]["loss"]):
        fail(f"--device_audio ran {audio_state.step} steps")
    del audio_state
    part("resume_checkpoint_device_audio")
    fed = phase_feed(torch, dev, work, sd)
    part("feed")
    host_aug = phase_host_aug(torch, dev, work)
    part("host_aug")
    graph = phase_graph(torch, dev, work, sd, fed)
    part("graph")
    dp = phase_dp(torch, dev, work, [h["steps"] * TRAIN_BATCH / h["seconds"]
                                     for h in history])
    emit("dp", nvidia_smi=nvidia_smi(), **dp)
    part("dp")

    prof = profile_steps(torch, dev, state.model, work,
                         train_argv(work, "exp_profile"),
                         (ATTN_FWD_PER_STEP, ATTN_BWD_PER_STEP),
                         {"spatial": (49, 32), "temporal": (17, 64),
                          "au_tokens": (12, 32)})
    part("profile")
    losses = overfit(torch, dev, sd, work)
    if not (np.isfinite(losses).all()
            and np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])):
        fail(f"the overfit run's AU loss did not fall: {losses}")

    del state
    torch.cuda.empty_cache()

    # the zoo: one fp32 step of every non-avformer model on the card
    # against the CPU; then the main path python -m auformer_torch.train
    # --model_name vformer (1 epoch, bf16, --device_augment), its launches
    # counted from 0 just before it; then its profiled steps and 3 bf16
    # steps of every other zoo model at full width
    part("overfit")
    zoo_steps = zoo_card_vs_cpu_steps(torch, dev)
    part("zoo_card_vs_cpu_step")
    vf_argv = train_argv(work, "exp_vformer", "--model_name", "vformer",
                         "--modality", "V", "--epochs", "1")
    torch.cuda.reset_peak_memory_stats()
    fused_attention.launches = fused_attention.backward_calls = 0
    mel_frontend.launches = 0
    t0 = time.perf_counter()
    vf_state, vf_history = train.main(vf_argv)
    torch.cuda.synchronize()
    vf_s = time.perf_counter() - t0
    vf_launches = {"attention": fused_attention.launches,
                   "mel": mel_frontend.launches}
    vf_backward = fused_attention.backward_calls
    vf_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    vf_steps = sum(h["steps"] for h in vf_history)
    fwd, bwd = VFORMER_ATTN_PER_STEP
    vf_want = {"attention": fwd * (vf_steps + len(vf_history)), "mel": 0}
    if (len(vf_history) != 1 or vf_launches != vf_want
            or vf_backward != bwd * vf_steps):
        fail(f"train.main --model_name vformer: {len(vf_history)} epochs, "
             f"{vf_steps} steps, launches {vf_launches} (expected "
             f"{vf_want}), backward calls {vf_backward}")
    h = vf_history[0]
    if not (np.isfinite(h["loss"]) and np.isfinite(h["score"])):
        fail(f"vformer epoch has no finite loss and score: {h}")
    cfg_vf = Config(model_name="vformer", modality="V",
                    compute_dtype="float32", image_size=IMAGE,
                    n_frames=FRAMES)
    fresh = build_model(cfg_vf, dtype=torch.float32)
    load_weights(fresh, load_reference_state_dict(
        str(work / "exp_vformer" / "pretrain" / "latest.pth")))
    fresh.to(dev).eval()
    batch = on(torch, train_batch(np.random.RandomState(SEED + 10), 8), dev)
    vf_logits = []
    for model in (vf_state.model.eval(), fresh):
        with torch.no_grad():
            vf_logits.append(tstep._forward(cfg_vf, model, tstep.prep_batch(
                batch, train=False)))
    vf_ckpt_err = (vf_logits[0] - vf_logits[1]).abs().max().item()
    if not (torch.isfinite(vf_logits[0]).all() and vf_ckpt_err <= 1e-5):
        fail(f"vformer's latest.pth reloaded gives logits {vf_ckpt_err} "
             "from the trained model's")
    del fresh
    vf_prof = profile_steps(torch, dev, vf_state.model, work, vf_argv,
                            VFORMER_ATTN_PER_STEP, VFORMER_SITES)
    del vf_state
    torch.cuda.empty_cache()
    part("vformer")
    zoo_train = zoo_train_steps(torch, dev)
    part("zoo_train_steps")
    graph["zoo"] = {name: r.pop("graph") for name, r in zoo_train.items()}
    emit("graph", nvidia_smi=nvidia_smi(), batch=TRAIN_BATCH,
         steps_per_dispatch={"checks": GRAPH_K, "fed_loop": FEED_GRAPH_K},
         **graph)

    warm = history[1]
    emit("train", videos=list(TRAIN_FRAMES), image=IMAGE, t=FRAMES,
         batch=TRAIN_BATCH, fixture_s=fixture_s,
         attention_gradient=grad_cases, model_gradient=model_grads,
         card_vs_cpu_step=step_check, augmentation=aug,
         main={"seconds": main_s, "epochs": len(history), "steps": steps,
               "launches": launches, "backward_calls": backward_calls},
         loss_per_epoch=[h["loss"] for h in history + resumed],
         score_per_epoch=[h["score"] for h in history + resumed],
         train_clips_per_s_epoch2=warm["steps"] * TRAIN_BATCH
         / warm["seconds"],
         step_timer_ms_epoch2={"data": warm["data_ms"],
                               "step": warm["step_ms"]},
         eval_s=[h["eval_seconds"] for h in history + resumed],
         epoch_s=[h["seconds"] for h in history + resumed],
         checkpoint_max_abs_err=ckpt_err,
         device_audio={"steps": 5, "seconds": audio_s,
                       "loss": audio_hist[0]["loss"]},
         overfit_au_loss=losses, profile=prof, peak_memory_mb=peak_mb,
         zoo_card_vs_cpu_step=zoo_steps,
         vformer={"seconds": vf_s, "steps": vf_steps,
                  "launches": vf_launches, "backward_calls": vf_backward,
                  "loss": h["loss"], "score": h["score"],
                  "train_clips_per_s": h["steps"] * TRAIN_BATCH
                  / h["seconds"],
                  "step_timer_ms": {"data": h["data_ms"],
                                    "step": h["step_ms"]},
                  "epoch_s": h["seconds"], "eval_s": h["eval_seconds"],
                  "checkpoint_max_abs_err": vf_ckpt_err,
                  "peak_memory_mb": vf_peak_mb, "profile": vf_prof},
         zoo_train_steps=zoo_train,
         part_s=part_s, phase_s=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)   # the split and the .pth files
    launches = {key: launches[key] + vf_launches[key] for key in launches}
    return {"train": launches, "feed": fed["launches"],
            "host_aug": host_aug["launches"],
            "graph": graph["launches"], "dp": dp["launches"]}, grad_cases, {
        "avformer": prof["attention_in_step"],
        "vformer": vf_prof["attention_in_step"],
        "graphed_step": graph["fed_loop"][f"k{FEED_GRAPH_K}"]["graph"][
            "launches_per_graphed_step"]}


def main() -> int:
    import torch
    if len(sys.argv) == 4 and sys.argv[1] == "dp_worker":
        return dp_worker(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import auformer_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_env(torch)
    phase_build()

    batch = make_batch(np.random.RandomState(SEED), BATCH)
    attn = attention_cases(torch, dev)
    mel = mel_cases(torch, dev, batch)
    emit("kernels", attention=attn, mel=mel, profiler=dict(PROFILER_LOG))

    by_path = {"slice": phase_slice(torch, dev, batch),
               "sweep": phase_sweep(torch, dev)}
    by_path["dataset"], by_path["packed"], split = phase_dataset(torch, dev)
    by_path["zoo"] = phase_zoo(torch, dev, split)
    by_path["ingest"] = phase_ingest(
        torch, dev, Path(split["work"]) / "experiments" / "avformer"
        / "pretrain" / f"random_seed{SEED}.pth")
    by_path["orbax"] = phase_orbax(torch, dev, split)
    by_path["decode"], yuv = phase_decode(torch, dev)
    shutil.rmtree(split["work"], ignore_errors=True)  # the split, the .pth
    by_path["quickstart"], quickstart_grads = phase_quickstart(torch, dev)
    paths, grad_cases, attention_in_step = phase_train(torch, dev)
    by_path.update(paths)
    emit("done", seconds=time.perf_counter() - T_START,
         profiler=PROFILER_LOG)

    from auformer_torch.ops import build

    def launches(name: str) -> int:
        return sum(counts.get(name, 0) for counts in by_path.values())

    def per_call(path: str, dtype: str) -> dict:
        """Sums over one call's attention launches (time x launches)."""
        sites = [c for c in attn if c["path"] == path and c["dtype"] == dtype]
        total = {key: sum(c[key] * c["launches_per_call"] for c in sites)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        total["bound_by"] = ("bytes" if all(c["bound_by"] == "bytes"
                                            for c in sites) else "operations")
        total["max_abs_err"] = max(c["max_abs_err"] for c in sites)
        return total

    dtypes = ("bfloat16", "float32")
    per_bucket = {d: per_call("sweep", d) for d in dtypes}
    per_packed_bucket = {d: per_call("packed", d) for d in dtypes}
    per_forward = {d: per_call("slice", d) for d in dtypes}
    mel_main = mel[1]                       # the slice's input: feature_len
    # the train step: per call at the fusion head's site, which takes 3 of
    # the step's 11 forward launches and all 3 backward calls, beside the
    # trace's device time of the kernel (all 11) and of the backward per
    # step
    train_step = {
        "fusion_head_per_call": {
            c["dtype"]: {key: c[key] for key in (
                "forward_ms", "backward_ms", "plain_fwd_bwd_ms",
                "library_fwd_bwd_ms", "forward_bound_ms",
                "backward_bound_ms")}
            for c in grad_cases if c["site"] == "fusion_head"},
        "launches_per_step": {"forward": ATTN_FWD_PER_STEP,
                              "forward_fusion_head": ATTN_HEAD_FWD_PER_STEP,
                              "backward": ATTN_BWD_PER_STEP},
        "traced_bf16": attention_in_step["avformer"],
        # --steps_per_dispatch: a CUDA graph's replay runs the launches its
        # capture recorded (counted per replay)
        "launches_per_graphed_step": attention_in_step["graphed_step"],
        # vformer trains every attention layer: per call at its spatial
        # and temporal sites, and the trace's device ms per step by site
        "vformer": {
            "launches_per_step": dict(zip(("forward", "backward"),
                                          VFORMER_ATTN_PER_STEP)),
            "per_call": {
                c["site"] + "_" + c["dtype"]: {key: c[key] for key in (
                    "shape", "forward_ms", "backward_ms", "plain_fwd_bwd_ms",
                    "library_fwd_bwd_ms", "forward_bound_ms",
                    "forward_bound_by", "backward_bound_ms",
                    "backward_bound_by")}
                for c in grad_cases if c["site"] in VFORMER_SITES},
            "traced_bf16": attention_in_step["vformer"]}}
    print(json.dumps({"kernels": [
        {"name": "attention", "route": "cuda",
         "source": str(build.source("attention").relative_to(ROOT)),
         "replaces": "auformer/ops/attention.py:88",
         "launches": launches("attention"),
         "launches_by_path": {p: c["attention"] for p, c in by_path.items()},
         **per_bucket["bfloat16"],
         "max_abs_err": max(c["max_abs_err"] for c in attn),
         "per_bucket": per_bucket, "per_packed_bucket": per_packed_bucket,
         "per_forward": per_forward,
         "train_step": train_step,
         "zoo_sites": {
             c["site"] + "_" + c["dtype"]: {key: c[key] for key in (
                 "shape", "launches_per_call", "ms", "plain_ms",
                 "library_ms", "bound_ms", "bound_by", "max_abs_err")}
             for c in attn if c["path"] == "zoo"},
         # the quickstart's vformer: per forward (1 spatial + 3 temporal
         # launches) and per site, and the gradient check at its sites
         "quickstart": {
             "per_forward": {d: per_call("quickstart", d) for d in dtypes},
             "launches_per_step": dict(zip(("forward", "backward"),
                                           VFORMER_ATTN_PER_STEP)),
             "sites": {
                 c["site"] + "_" + c["dtype"]: {key: c[key] for key in (
                     "shape", "launches_per_call", "ms", "plain_ms",
                     "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                 for c in attn if c["path"] == "quickstart"},
             "gradient": {
                 c["site"] + "_" + c["dtype"]: {key: c[key] for key in (
                     "shape", "max_abs_err_out", "max_abs_err_grad",
                     "forward_ms", "backward_ms", "plain_fwd_bwd_ms",
                     "library_fwd_bwd_ms", "forward_bound_ms",
                     "forward_bound_by", "backward_bound_ms",
                     "backward_bound_by")}
                 for c in quickstart_grads}}},
        {"name": "mel_frontend", "route": "cuda",
         "source": str(build.source("mel").relative_to(ROOT)),
         "replaces": "auformer/ops/audio_pallas.py:185",
         "launches": launches("mel"),
         "launches_by_path": {p: c["mel"] for p, c in by_path.items()},
         "max_abs_err": max(c["max_abs_err"] for c in mel),
         "ms": mel_main["ms"], "plain_ms": mel_main["plain_ms"],
         "bound_ms": mel_main["bound_ms"], "bound_by": mel_main["bound_by"],
         "library_ms": None},
        {"name": "yuv_rgb", "route": "cuda",
         "source": str(build.source("yuv_rgb").relative_to(ROOT)),
         "replaces": "auformer/data/video.py:70 (cv2's conversion on the "
                     "host; no TPU kernel)",
         "launches": launches("yuv_rgb"),
         "launches_by_path": {"decode": by_path["decode"]["yuv_rgb"]},
         **{key: yuv[key] for key in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")}}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
