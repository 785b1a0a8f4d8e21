"""Training entry point (counterpart of the root train.py; reference
train.py:339-343), on the GPU:

    python -m auformer_torch.train -t AU -mn avformer [flags as opts.py]

Without ``--device_augment`` the loader augments each clip on the host
(data/transforms.py), as the reference does; ``--device_augment`` moves
the AutoAugment into the train step.

``-mn`` takes every model of the zoo (avformer, vformer, sformer,
tformer, dsformer, vggformer, audio, van, emonet, i3d, mc3d, tsav,
resnet); the single-frame models (sformer, dsformer, van, emonet, resnet)
train with ``--n_frames 1``, emonet at a multiple of 64 (``--image_size
256``, its full width).

Checkpoints go to ``{exp_dir}/pretrain/{latest,best}.pth`` in the reference
layout; ``--resume`` reads the JAX package's orbax ``latest/`` there first
(a run begun on the TPU), ``latest.pth`` second.

Data parallel over N GPUs, one process each (train_lib's docstring):

    python -m torch.distributed.run --nproc_per_node N \
        -m auformer_torch.train [flags]

``--batch_size`` is the global batch, which N must divide.
"""
from __future__ import annotations

from . import train_lib
from .core.config import parse_opt
from .core.mesh import process_group_scope


def main(argv: list[str] | None = None, device=None):
    """Parse ``argv`` (default: the command line), train, and return
    ``(state, history)``. ``device``: ``cuda`` unless given (the tests pass
    ``"cpu"``). A process group that training joins from ``torchrun``'s
    environment is destroyed on the way out."""
    cfg = parse_opt(argv)
    print(f"Task: {cfg.task}")
    print("Model:", cfg.model_name)
    print("Modality:", cfg.modality)
    print("clip size", cfg.n_frames, cfg.image_size)
    with process_group_scope():
        return train_lib.train(cfg, device=device)


if __name__ == "__main__":
    main()
