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
           bf16 forward (device time, kernels per forward), and
           run_inference into a temporary directory
  sweep    the full-width dense sweep of a synthetic 2,100-frame video
           (30 fps timestamps, 70 s wav; buckets of 1280 and 820 label
           frames): launch counts per bucket and of run_inference_sweep,
           phase-mel features of 16 windows against the per-window route,
           fp32 sweep logits against the fp32 clip path, the forced
           per-window route against the phase route, label frames/s in
           bf16, device ms, kernels and ms by stage per bucket, idle share,
           peak memory, and the submission files of run_inference_sweep

Then one JSON line of per-kernel results: for attention, sums over one
sweep bucket's calls in bf16 (the main path's dtype), with the per-bucket
sums in both dtypes (``per_bucket``) and the clip path's per-forward sums
(``per_forward``); ``launches`` counts the slice's and the sweep's main
path runs. Then the nvidia-smi name/power line, and last
``{"ok": true, "device": {...}}``. Without a GPU, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 8            # clips per forward
FRAMES = 16
IMAGE = 112
HEADS = 8

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# the dense sweep's synthetic video and the bucket the default (2048) cap
# splits it into: 1280 + 820 label frames
SWEEP_FRAMES = 2100
SWEEP_WAV_SECS = 70
SWEEP_BSIZE = 1280
SECOND_FRAMES = 300  # a second, shorter video for run_inference_sweep
LABEL_FRAME = 48     # T=16, dilation 3
# 16 label frames whose windows are held against the per-window route and
# the clip path: short (ts < 10 s), full, truncated by the end of the file
# (ts > 65 s), both buckets' first and last rows and the boundary at 1280
FEATURE_WINDOWS = (0, 1, 5, 47, 48, 299, 300, 600, 1000, 1279, 1280, 1281,
                   1950, 2000, 2098, 2099)

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
                   ("sweep", "au_tokens", 12, 32, SWEEP_BSIZE, 7))
ATTN_PER_CALL = 11
ATTN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-3)}
MEL_ATOL = 2e-3          # normalized units (0.04 dB): sum order only
SLICE_TOL = (2e-3, 2e-4)  # rtol, atol: card fp32 vs CPU fp32 logits
SWEEP_TOL = (2e-3, 2e-4)  # rtol, atol: fp32 sweep vs fp32 clip path
FEATURE_ATOL = 1e-4       # normalized units: phase-mel vs per-window, f32


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def on_device(event) -> bool:
    return str(event.device_type).endswith("CUDA")


def timed(torch, fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """(device ms, event ms) per call of ``fn``. Device ms: the device time
    of everything one call launches, from torch.profiler (CUPTI). Event ms:
    CUDA events around ``iters`` back-to-back calls; where a call's kernels
    are shorter than its host-side launch cost, this is the host's rate."""
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.device_time_total for e in prof.key_averages()
                    if on_device(e))
    if device_us <= 0:
        fail("the profiler recorded no device time")
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


def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
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
    if any(count == 0 for count in tensor_core.values()):
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
    """Device time by kernel over 3 forwards (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    infer(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            infer(batch)
        torch.cuda.synchronize()
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


def check_submission(result_dir: str, want_rows: dict, out) -> None:
    """Each video's AU file: the header and one row of 12 binary labels per
    label frame (``want_rows``: video id -> rows); inference.pkl holds the
    returned (rows, 21) predictions."""
    for vid, rows in want_rows.items():
        lines = Path(result_dir, "au", f"{vid}.txt").read_text().splitlines()
        if (lines[0] != "AU1,AU2,AU4,AU6,AU7,AU10,AU12,AU15,AU23,AU24,AU25,"
                        "AU26" or len(lines) != rows + 1
                or any(set(ln) - set("01,") or ln.count(",") != 11
                       for ln in lines[1:])):
            fail(f"submission file of {vid} is malformed")
    with open(Path(result_dir, "inference.pkl"), "rb") as f:
        preds = pickle.load(f)["predictions"]
    n = sum(want_rows.values())
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
         device_idle_share_bf16=1.0 - prof["device_ms_per_forward"] / wall_ms,
         peak_memory_mb_bf16=peak_mb, profile_bf16=prof,
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


class BucketCounts:
    """Launch counts per bucket: wraps a sweep's ``fused_sweep`` (called
    once per bucket) and records the launches each call adds."""

    def __init__(self, sweep, fused_attention, mel_frontend):
        self.calls = []
        inner = sweep.fused_sweep

        def counted(*args, **kwargs):
            before = fused_attention.launches, mel_frontend.launches
            out = inner(*args, **kwargs)
            self.calls.append(
                {"attention": fused_attention.launches - before[0],
                 "mel": mel_frontend.launches - before[1]})
            return out
        sweep.fused_sweep = counted


def stage_profile(torch, sweep, run) -> dict:
    """Device ms of one ``run()`` by stage: record_function ranges around
    the sweep's methods, each range's device time the sum of the kernels
    launched inside it. Stages: the phase table (once per video), the
    phase-mel features (edge frames, gather, dB; a bucket minus its
    fused_sweep), the trunk, the audio resnet, and the heads (fused_sweep
    minus trunk and audio: T-Former, AU_formers, fusion, window gather)."""
    from torch.profiler import ProfilerActivity, profile, record_function
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
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for attr, fn in saved.items():
            if attr == "a_net":
                sweep.a_net = fn
            else:
                delattr(sweep, attr)
    us = {label: 0.0 for label in names.values()}
    for e in prof.events():
        label = e.name[len("sweep/"):]
        if (e.name.startswith("sweep/") and label in us
                and str(e.device_type).endswith("CPU")):
            us[label] += e.device_time_total
    ms = {k: v / 1e3 for k, v in us.items()}
    stages = {"phase_table": ms["table"],
              "phase_features": ms["bucket"] - ms["fused_sweep"],
              "trunk": ms["trunk"], "audio_resnet": ms["audio_resnet"],
              "heads": ms["fused_sweep"] - ms["trunk"] - ms["audio_resnet"]}
    if min(ms["bucket"], ms["trunk"], ms["audio_resnet"]) <= 0:
        fail(f"the profiler attributed no device time to a stage: {ms}")
    return stages


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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    events = [e for e in prof.key_averages()
              if on_device(e) and e.device_time_total > 0]
    device_ms = sum(e.device_time_total for e in events) / 1e3
    kernels = sum(e.count for e in events)
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    stages = stage_profile(torch, sweep16, run)

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
        device_ms_per_bucket_bf16=device_ms / n_buckets,
        device_idle_share_bf16=1.0 - device_ms / (1e3 * wall_s),
        device_kernels_per_bucket_bf16=kernels / n_buckets,
        stage_device_ms_per_video_bf16=stages,
        peak_memory_mb_bf16=peak_mb,
        top=[{"name": e.key[:80], "ms_per_video": e.device_time_total / 1e3,
              "calls_per_video": e.count} for e in events[:12]])
    emit("sweep", **result)
    return launches


def main() -> int:
    import torch
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
    emit("kernels", attention=attn, mel=mel)

    launches = phase_slice(torch, dev, batch)
    sweep_launches = phase_sweep(torch, dev)

    from auformer_torch.ops import build

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
    per_forward = {d: per_call("slice", d) for d in dtypes}
    mel_main = mel[1]                       # the slice's input: feature_len
    print(json.dumps({"kernels": [
        {"name": "attention", "route": "cuda",
         "source": str(build.source("attention").relative_to(ROOT)),
         "replaces": "auformer/ops/attention.py:88",
         "launches": launches["attention"] + sweep_launches["attention"],
         **per_bucket["bfloat16"],
         "max_abs_err": max(c["max_abs_err"] for c in attn),
         "per_bucket": per_bucket, "per_forward": per_forward},
        {"name": "mel_frontend", "route": "cuda",
         "source": str(build.source("mel").relative_to(ROOT)),
         "replaces": "auformer/ops/audio_pallas.py:185",
         "launches": launches["mel"] + sweep_launches["mel"],
         "max_abs_err": max(c["max_abs_err"] for c in mel),
         "ms": mel_main["ms"], "plain_ms": mel_main["plain_ms"],
         "bound_ms": mel_main["bound_ms"], "bound_by": mel_main["bound_by"],
         "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
