"""Typed configuration + opts-compatible CLI.

The flag surface mirrors the reference ``opts.py:4-43`` verbatim (task/root/
exp_dir/cache_dir/lmdb_label_dir/image_size/modality; model group; training
group; dataloader group) so reference command lines keep working. The
"TPU Parameters" group keeps the JAX package's flags and names, so one
command line drives either package.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any


@dataclasses.dataclass
class Config:
    # -- reference-compatible surface (opts.py) ------------------------------
    task: str = "AU"                      # one of ALL, EX, AU, VA
    root: str = "./data/aff2_processed"
    exp_dir: str = "experiments/avformer"
    cache_dir: str = "./data/cached_data"
    lmdb_label_dir: str = "./data/112_align/lmdb"
    image_size: int = 112
    modality: str = "A;V"                 # subset of 'A;V;M'

    # model group
    dropout_rate: float = 0.2
    model_name: str = "avformer"

    # training group
    seed: int = 123
    learning_rate: float = 5e-4
    n_warmup_steps: int = 0
    grad_clip: float = -1.0
    weight_decay: float = 5e-5
    epochs: int = 60
    batch_size: int = 64
    gpu_id: int = 0                       # kept for CLI parity; the entry points
                                          # take an explicit ``device``
    early_stop_step: int = 30
    resume: bool = False
    start_epoch: int = 15
    eval_step: int = 1

    # dataloader group
    n_frames: int = 16
    dilation: int = 3
    downsample_rate: int = 100
    audio_len_secs: int = 10
    audio_shift_secs: int = 5
    n_mels: int = 64

    # -- TPU-native additions -------------------------------------------------
    mesh_shape: str = "data:-1"           # axis spec, e.g. "data:-1" or "data:4,model:2"
    compute_dtype: str = "bfloat16"       # matmul/conv compute dtype
    param_dtype: str = "float32"
    use_pallas: bool = True               # kept for CLI parity with the JAX package;
                                          # read by nothing here: CUDA tensors always
                                          # take the hand-written kernels (ops/)
    lr_schedule: bool = True              # honor the *intended* x0.1 @ epoch 30/60 decay
                                          # (a no-op bug in the reference, train.py:181-185)
    data_backend: str = "frames"          # 'frames' (native record store) | 'synthetic'
    host_threads: int = 4                 # host decode thread pool
    prefetch_depth: int = 2               # device feed double buffering
    eval_batch_mult: int = 4              # val batch = batch_size * this (train.py:251)
    log_every: int = 50
    strict_parity: bool = False           # f32 everywhere for bit-faithful checks
    profile_dir: str = ""                 # profiler trace dir ("" = off)
    device_augment: bool = False          # AutoAugment in the step instead of on the host
    device_audio: bool = False            # mel frontend on device inside the train/eval
                                          # step (host ships raw windows; kills the
                                          # ~6 ms/clip host STFT the reference pays in
                                          # __getitem__, aff2compdataset.py:227-238)
    mel_bf16: bool = False                # opt-in bf16 DFT conv in the mel frontend
                                          # (~0.05 dB error, ~4x MXU rate; NOT bit-faithful)
    audio_arena_mb: float = 4096.0        # HBM budget for the resident wav arena
                                          # (device_audio: videos' waveforms upload
                                          # once; batches carry int32 window offsets
                                          # instead of 1.76 MB raw windows). 0 = off,
                                          # over-budget datasets fall back to windows.
    steps_per_dispatch: int = 1           # K optimizer steps per device program
                                          # (lax.scan over stacked loader batches);
                                          # amortizes per-dispatch overhead on
                                          # high-latency links (RPC-tunneled TPUs)
    frame_dedup: bool = False             # ship unique decoded frames + an int32
                                          # (B, T) window map per batch and expand
                                          # clips on device (parallel/step.py::
                                          # make_clip_expander): overlapping dilated
                                          # windows then cost ~1 decode + ~1 H2D
                                          # frame each instead of clip_len of both.
                                          # Requires device_augment (host aug
                                          # is per-sample and would fork shared
                                          # frames before dedup could see them).
    locality_run: int = 0                 # train sampler: shuffle contiguous runs
                                          # of this many indices instead of single
                                          # indices (BlockShuffleSampler). 0 = fully
                                          # shuffled. Overlapping windows inside a
                                          # run share clip_len-1 of clip_len frames,
                                          # so decode/H2D drop ~batch*T/(run+T*dil)
                                          # -fold with frame_dedup or the LRU.

    # -- derived / runtime -----------------------------------------------------
    checkpoint_path: str = ""
    steps_per_epoch: int = 0  # filled by the training entry point; used by lr decay

    # audio constants fixed by the reference (aff2compdataset.py:47-65)
    sample_rate: int = 44100
    window_size: float = 20e-3
    window_stride: float = 10e-3

    @property
    def use_mask(self) -> bool:
        return "M" in self.modality

    @property
    def use_audio(self) -> bool:
        return "A" in self.modality.split(";")

    @property
    def clip_channels(self) -> int:
        # reference VideoModel.config_modality (vformer.py:313-331)
        if "M" in self.modality:
            return 4 if "V" in self.modality else 1
        return 3

    @property
    def label_frame(self) -> int:
        return self.n_frames * self.dilation

    @property
    def sample_len_frames(self) -> int:
        return self.audio_len_secs * self.sample_rate

    @property
    def audio_shift_samples(self) -> int:
        return self.audio_shift_secs * self.sample_rate

    @property
    def n_fft(self) -> int:
        import math
        return 2 ** math.ceil(math.log2(self.window_size * self.sample_rate))

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)   # 882

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)  # 441

    @property
    def mel_frames(self) -> int:
        # (sample_len_secs / window_stride) + 1 (aff2compdataset.py:236)
        return int(self.audio_len_secs / self.window_stride) + 1  # 1001

    def asdict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="auformer_torch: AU detection on CUDA")
    p.add_argument("--task", "-t", type=str, default="AU",
                   help="task, one of [ALL, EX, AU, VA]")
    p.add_argument("--root", "-r", type=str, default="./data/aff2_processed")
    p.add_argument("--exp_dir", "-ed", type=str, default="experiments/avformer")
    p.add_argument("--cache_dir", "-cd", type=str, default="./data/cached_data")
    p.add_argument("--lmdb_label_dir", "-lld", type=str, default="./data/112_align/lmdb")
    p.add_argument("--image_size", type=int, default=112)
    p.add_argument("--modality", "-md", type=str, default="A;V")

    model = p.add_argument_group(title="Model Parameters")
    model.add_argument("--dropout_rate", type=float, default=0.2)
    model.add_argument(
        "--model_name", "-mn", type=str, default="avformer",
        help="avformer, vformer, sformer, tformer, dsformer, vggformer, "
             "audio, van, emonet, i3d, mc3d, tsav or resnet (any other name "
             "builds the resnet baseline)")

    training = p.add_argument_group(title="Training Parameters")
    training.add_argument("--seed", default=123, type=int)
    training.add_argument("--learning_rate", "-lr", default=5e-4, type=float)
    training.add_argument("--n_warmup_steps", type=int, default=0)
    training.add_argument("--grad_clip", type=float, default=-1)
    training.add_argument("--weight_decay", type=float, default=5e-5)
    training.add_argument("-e", "--epochs", type=int, default=60)
    training.add_argument("-b", "--batch_size", type=int, default=64)
    training.add_argument("--gpu_id", type=int, default=0)
    training.add_argument("--early_stop_step", type=int, default=30)
    training.add_argument("--resume", action="store_true")
    training.add_argument("--start_epoch", type=int, default=15)
    training.add_argument("--eval_step", type=int, default=1)

    dl = p.add_argument_group(title="Dataloader Parameters")
    dl.add_argument("--n_frames", "--clip_len", type=int, default=16)
    dl.add_argument("--dilation", type=int, default=3)
    dl.add_argument("--downsample_rate", "-ds", type=int, default=100)
    dl.add_argument("--audio_len_secs", "-als", type=int, default=10)
    dl.add_argument("--audio_shift_secs", "-ass", type=int, default=5)
    dl.add_argument("--n_mels", type=int, default=64)

    tpu = p.add_argument_group(title="TPU Parameters")
    tpu.add_argument("--mesh_shape", type=str, default="data:-1")
    tpu.add_argument("--compute_dtype", type=str, default="bfloat16",
                     choices=["bfloat16", "float32"])
    tpu.add_argument("--param_dtype", type=str, default="float32")
    tpu.add_argument("--no_pallas", dest="use_pallas", action="store_false")
    tpu.add_argument("--no_lr_schedule", dest="lr_schedule", action="store_false")
    tpu.add_argument("--data_backend", type=str, default="frames",
                     choices=["frames", "synthetic"])
    tpu.add_argument("--host_threads", type=int, default=4)
    tpu.add_argument("--prefetch_depth", type=int, default=2)
    tpu.add_argument("--strict_parity", action="store_true")
    tpu.add_argument("--profile_dir", type=str, default="")
    tpu.add_argument("--device_augment", action="store_true")
    tpu.add_argument("--device_audio", action="store_true")
    tpu.add_argument("--audio_arena_mb", type=float, default=4096.0)
    tpu.add_argument("--mel_bf16", action="store_true")
    tpu.add_argument("--steps_per_dispatch", type=int, default=1)
    tpu.add_argument("--frame_dedup", action="store_true")
    tpu.add_argument("--locality_run", type=int, default=0)
    return p


def parse_opt(argv: list[str] | None = None) -> Config:
    args = build_parser().parse_args(argv)
    cfg = Config.from_dict(vars(args))
    assert cfg.task in ("ALL", "EX", "AU", "VA"), f"bad task {cfg.task}"
    if cfg.strict_parity:
        cfg.compute_dtype = "float32"
    return cfg
