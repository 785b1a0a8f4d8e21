"""Inference entry point (counterpart of the root test_aff2.py; reference
test_aff2.py): loads the avformer weights, sweeps the test split of the
Aff-Wild2-layout dataset that the flags name, and writes per-video AU
submission txts and inference.pkl under ``results/`` in the working
directory, on the GPU.

    python -m auformer_torch.test_aff2 [flags as opts.py, e.g.
        --data_backend synthetic]

Weights, in the root test_aff2.py's order (:26-45), under
``experiments/avformer/pretrain/``: the orbax checkpoint ``best/`` that the
JAX package's training writes, else its ``latest/`` (read without orbax,
core/orbax_reader.py), else the first ``*.pth`` (a reference checkpoint,
e.g. the shipped best523.pth, test_aff2.py:18,62, or the ``best.pth`` /
``latest.pth`` that ``python -m auformer_torch.train`` writes there), else
random weights with a warning. A checkpoint merges into the model's own
values as the JAX package's ``load_checkpoint(target=)`` does
(core/checkpointing.py). ``AUFORMER_SWEEP=0`` selects the clip path
(``run_inference``) instead of the dense sweep (``run_inference_sweep``,
the default).

Over N GPUs, the test split's videos spread over the ranks, rank 0
writing the files:

    python -m torch.distributed.run --nproc_per_node N \
        -m auformer_torch.test_aff2 [flags]
"""
from __future__ import annotations

import glob
import os

import torch

from .core.checkpointing import model_state_dict, read_checkpoint
from .core.config import parse_opt
from .core.mesh import make_mesh, maybe_init_distributed, process_group_scope
from .core.weights import load_weights
from .infer import resolve_device, run_inference, run_inference_sweep
from .nn import build_model

MODEL_PATH = os.path.join("experiments", "avformer", "pretrain")
RESULT_PATH = "results"


def checkpoint_path(model_path: str = MODEL_PATH) -> str | None:
    """The checkpoint that the root test_aff2.py loads from
    ``model_path``: orbax ``best/``, orbax ``latest/``, the first
    ``*.pth``; None without one."""
    for name in ("best", "latest"):
        if os.path.isdir(os.path.join(model_path, name)):
            return os.path.join(model_path, name)
    pths = sorted(glob.glob(os.path.join(model_path, "*.pth")))
    return pths[0] if pths else None


def main(argv: list[str] | None = None, device=None):
    """Parse ``argv`` (default: the command line), run, and return the
    (len(dataset), 21) prediction matrix. ``device``: ``cuda`` unless
    given (the tests pass ``"cpu"``). Under ``torchrun`` the process joins
    the group its environment describes and serves its share of the
    videos (``make_mesh``); the group is destroyed on the way out."""
    cfg = parse_opt(argv)
    cfg.model_name = "avformer"
    cfg.modality = "A;V"
    cfg.task = "AU"
    torch.manual_seed(cfg.seed)
    model = build_model(cfg)
    path = checkpoint_path()
    if path is not None:
        load_weights(model, read_checkpoint(path, "avformer",
                                            target=model_state_dict(model)))
        kind = "orbax" if os.path.isdir(path) else "torch"
        print(f"restored {kind} checkpoint: {path}")
        print(f"Loading weight from: {MODEL_PATH}")
    else:
        print("WARNING: no checkpoint found, using random init")
    with process_group_scope():
        device = resolve_device(device)
        maybe_init_distributed(device)
        mesh = make_mesh(cfg.mesh_shape, device)
        run = (run_inference_sweep
               if os.environ.get("AUFORMER_SWEEP", "1") != "0"
               else run_inference)
        return run(cfg, model, result_path=RESULT_PATH, device=device,
                   mesh=mesh)


if __name__ == "__main__":
    main()
