#!/usr/bin/env python3
"""Drive the auformer_torch main path on one CUDA GPU and hold each
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failed check exits non-zero):

  env      torch / CUDA versions, the card's name and power limit
  build    nvcc for every kernel under auformer_torch/csrc, all at once
  kernels  each kernel at every main-path shape against its plain version
           on the card: max error beside its tolerance, kernel / plain /
           library time, roofline bound
  slice    full-width avformer clip-batch inference (112x112, T=16, B=8,
           random reference-layout weights from a seed): launch counts of
           one forward, fp32 logits against the same port on the CPU,
           clips/s in fp32 and bf16, a profiled bf16 forward, and
           run_inference into a temporary directory

Then one JSON line of per-kernel results, the nvidia-smi name/power line,
and last ``{"ok": true, "device": {...}}``. Without a GPU, or outside a
checkout of the repository, it exits non-zero and prints no result.
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

# attention sites of one avformer forward: (name, tokens, head dim,
# (batch*head) rows per clip, launches per forward)
ATTENTION_SITES = (("spatial", 49, 32, FRAMES * HEADS, 1),
                   ("temporal", 17, 64, HEADS, 3),
                   ("au_tokens", 12, 32, HEADS, 7))
ATTN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-3)}
MEL_ATOL = 2e-3          # normalized units (0.04 dB): sum order only
SLICE_TOL = (2e-3, 2e-4)  # rtol, atol: card fp32 vs CPU fp32 logits


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
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         sources=[str(build.source(n).relative_to(ROOT))
                  for n in build.KERNELS], ptxas=ptxas)


def attention_cases(torch, dev) -> list[dict]:
    import torch.nn.functional as F
    from auformer_torch.ops.attention import (attention_reference,
                                              fused_attention)
    rs = np.random.RandomState(SEED + 1)
    cases = []
    for site, n, d, rows_per_clip, per_forward in ATTENTION_SITES:
        shape = (BATCH * rows_per_clip // HEADS, HEADS, n, d)
        base = [rs.randn(*shape).astype(np.float32) for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(t).to(dev, dtype) for t in base)
            scale = d ** -0.5
            got = fused_attention(q, k, v, scale)
            want = attention_reference(q, k, v, scale)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            rtol, atol = ATTN_TOL[dname]
            err = (got.float() - want.float()).abs().max().item()
            if not torch.allclose(got.float(), want.float(), rtol=rtol,
                                  atol=atol):
                fail(f"attention {site} {dname}: max |err| {err}")
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
                site=site, dtype=dname, shape=list(shape),
                launches_per_forward=per_forward, max_abs_err=err,
                rtol=rtol, atol=atol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, event_ms=ev,
                plain_event_ms=plain_ev, library_event_ms=lib_ev))
    return cases


def mel_bound(b: int, valid_frames: int) -> tuple[float, str]:
    nbytes = (b * 441000 * 4 + b * 64 * 1001 * 4 + b * 4   # audio, out, flen
              + 882 * 576 * 2 * 2 + 576 * 64 * 4)         # basis, filterbank
    dft = 2 * valid_frames * 882 * 1026      # bf16 operands
    mel = 2 * valid_frames * 513 * 64        # f32
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
            "top": [{"name": e.key[:80],
                     "ms_per_forward": e.device_time_total / 3e3,
                     "calls_per_forward": e.count / 3}
                    for e in events[:12]]}


def check_submission(result_dir: str, batches: list, out) -> None:
    want_rows = {}
    for b in batches:
        for vid in b["video_id"]:
            want_rows[vid] = want_rows.get(vid, 0) + 1
    for vid, rows in want_rows.items():
        lines = Path(result_dir, "au", f"{vid}.txt").read_text().splitlines()
        if (lines[0] != "AU1,AU2,AU4,AU6,AU7,AU10,AU12,AU15,AU23,AU24,AU25,"
                        "AU26" or len(lines) != rows + 1
                or any(set(ln) - set("01,") or ln.count(",") != 11
                       for ln in lines[1:])):
            fail(f"submission file of {vid} is malformed")
    with open(Path(result_dir, "inference.pkl"), "rb") as f:
        preds = pickle.load(f)["predictions"]
    n = sum(len(b["Index"]) for b in batches)
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

    # the main path, once, with the launch counts read around it
    fused_attention.launches = 0
    mel_frontend.launches = 0
    logits = infer32(on_card)
    torch.cuda.synchronize()
    launches = {"attention": fused_attention.launches,
                "mel": mel_frontend.launches}
    want = sum(s[-1] for s in ATTENTION_SITES)
    if launches != {"attention": want, "mel": 1}:
        fail(f"launches per forward {launches}, expected attention {want} "
             f"and mel 1")

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

    cfg16 = Config(image_size=IMAGE, n_frames=FRAMES, batch_size=BATCH)
    model16 = build_model(cfg16)
    load_weights(model16, sd)
    infer16 = make_infer_fn(cfg16, model16)
    logits16 = infer16(on_card)
    if not torch.isfinite(logits16).all():
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
        check_submission(tmp, batches, out)

    wall_ms = 1e3 * BATCH / rate16
    emit("slice", batch=BATCH, frames=FRAMES, image=IMAGE,
         launches_per_forward=launches, max_abs_err_fp32_vs_cpu=err,
         rtol=SLICE_TOL[0], atol=SLICE_TOL[1], cpu_forward_s=cpu_s,
         max_abs_diff_bf16_vs_fp32=(logits16 - logits).abs().max().item(),
         clips_per_s={"float32": rate32, "bfloat16": rate16},
         wall_ms_per_forward_bf16=wall_ms,
         device_idle_share_bf16=1.0 - prof["device_ms_per_forward"] / wall_ms,
         peak_memory_mb_bf16=peak_mb, profile_bf16=prof,
         run_inference={"batches": len(batches),
                        "rows": int(out.shape[0])})
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

    from auformer_torch.ops import build
    fp32 = [c for c in attn if c["dtype"] == "float32"]

    def per_forward(key):
        return sum(c[key] * c["launches_per_forward"] for c in fp32)

    mel_main = mel[1]                       # the slice's input: feature_len
    b_ms = per_forward("bound_ms")
    print(json.dumps({"kernels": [
        {"name": "attention", "route": "cuda",
         "source": str(build.source("attention").relative_to(ROOT)),
         "replaces": "auformer/ops/attention.py:88",
         "launches": launches["attention"],
         "max_abs_err": max(c["max_abs_err"] for c in fp32),
         "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
         "bound_ms": b_ms,
         "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in fp32)
         else "operations",
         "library_ms": per_forward("library_ms")},
        {"name": "mel_frontend", "route": "cuda",
         "source": str(build.source("mel").relative_to(ROOT)),
         "replaces": "auformer/ops/audio_pallas.py:185",
         "launches": launches["mel"],
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
