"""Checkpoints (counterpart of auformer/core/checkpointing.py; reference
utils.py:7-11, train.py:247,273-276).

The port writes ``torch.save`` of the model's reference-layout state dict
(CPU f32 tensors) at ``{dir}/{name}.pth``: ``latest.pth`` every epoch,
``best.pth`` from the early stopper. These are the files the upstream
reference reads and the JAX package's ``--resume`` falls back to
(train_lib.py:203-211, ``convert_checkpoint`` + ``merge_into``). Writing
``.pth`` where the JAX package writes orbax is a deliberate difference.

It reads both: :func:`load_checkpoint` takes the orbax directory
``{dir}/{name}/`` that the JAX package's ``save_checkpoint`` writes first
(core/orbax_reader.py, through ``state_dict_from_jax``), and
``{dir}/{name}.pth`` second, the JAX package's order at ``--resume``.
Given the model's own state dict, it merges as the JAX package's
``load_checkpoint(target=)`` does (auformer/core/checkpointing.py:43-55):
an array that the checkpoint lacks, or holds at another shape, keeps the
model's value, and a log line names it. Optimizer state is not saved, in
either package.
"""
from __future__ import annotations

import logging
import os
from typing import Mapping, Optional

import torch

from .orbax_reader import read_orbax_checkpoint
from .weights import export_jax, load_reference_state_dict

log = logging.getLogger(__name__)


def checkpoint_file(checkpoint_dir: str, name: str) -> str:
    return os.path.join(checkpoint_dir, f"{name}.pth")


def model_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's state dict as CPU tensors (f32 parameters and BatchNorm
    statistics; ``num_batches_tracked`` as torch keeps it)."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def save_checkpoint(checkpoint_dir: str,
                    state_dict: Mapping[str, torch.Tensor],
                    name: str = "latest") -> str:
    """Write ``state_dict`` to ``{checkpoint_dir}/{name}.pth`` (through a
    temporary file, so a reader never sees half a checkpoint)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = checkpoint_file(checkpoint_dir, name)
    torch.save(dict(state_dict), path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def _numpy(tree):
    """A restored tree's leaves as numpy (bfloat16 tensors widened)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def merge_state_dict(target: Mapping[str, torch.Tensor],
                     loaded: Mapping[str, torch.Tensor],
                     groups: list[list[str]]) -> dict[str, torch.Tensor]:
    """``target`` with each group of ``loaded`` (the torch keys of one
    checkpoint array) taken where every key of it is in ``target`` at the
    same shape; every other key of ``target`` keeps its value, logged by
    name (BatchNorm's ``num_batches_tracked``, which JAX lacks, silently).
    Arrays that the model lacks are left out, as JAX's merge leaves them."""
    out = dict(target)
    taken: set[str] = set()
    for group in groups:
        if not any(k in target for k in group):
            continue
        if all(k in target and loaded[k].shape == target[k].shape
               for k in group):
            out.update({k: loaded[k] for k in group})
            taken.update(group)
            continue
        for k in group:
            if k in target:
                log.warning("checkpoint: %s kept the model's value: stored "
                            "at shape %s, the model's is %s", k,
                            tuple(loaded[k].shape), tuple(target[k].shape))
                taken.add(k)
    for k in target:
        if k not in taken and not k.endswith("num_batches_tracked"):
            log.warning("checkpoint: %s kept the model's value: absent from "
                        "the checkpoint", k)
    return out


def read_checkpoint(path: str, model_name: str = "avformer",
                    target: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> dict[str, torch.Tensor]:
    """The reference-layout state dict of ``model_name`` at ``path``. An
    orbax directory (the JAX package's ``{"params", "batch_stats"}`` tree)
    goes through ``state_dict_from_jax``; a ``.pth`` loads as it is (the
    DDP ``module.`` prefix stripped). With ``target`` (the model's state
    dict), the result is :func:`merge_state_dict`'s, as JAX's
    ``target=``."""
    if os.path.isdir(path):
        e = export_jax(_numpy(read_orbax_checkpoint(path)), model_name,
                       lenient=target is not None)
        sd, groups = e.sd, e.groups
    else:
        sd = load_reference_state_dict(path)
        groups = [[k] for k in sd]
    return sd if target is None else merge_state_dict(target, sd, groups)


def load_checkpoint(checkpoint_dir: str, name: str = "latest",
                    model_name: str = "avformer",
                    target: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> Optional[dict[str, torch.Tensor]]:
    """:func:`read_checkpoint` of the orbax directory ``{dir}/{name}``,
    else of ``{dir}/{name}.pth``; None where neither is."""
    for path in (os.path.join(checkpoint_dir, name),
                 checkpoint_file(checkpoint_dir, name)):
        if os.path.isdir(path) or os.path.isfile(path):
            return read_checkpoint(path, model_name, target)
    return None


class EarlyStopper:
    """Best-score tracking + patience (reference train.py:84-103)."""

    def __init__(self, num_trials: int, checkpoint_dir: str):
        self.num_trials = num_trials
        self.trial_counter = 0
        self.best_accuracy = 0.0
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    def is_continuable(self, state_dict: Mapping[str, torch.Tensor] | None,
                       accuracy: float) -> bool:
        """Track ``accuracy``; a new best writes ``state_dict`` to
        ``best.pth`` (None writes nothing: a data-parallel rank other than
        0, which takes the same decisions from the same scores)."""
        if accuracy > self.best_accuracy:
            self.best_accuracy = accuracy
            self.trial_counter = 0
            if state_dict is not None:
                save_checkpoint(self.checkpoint_dir, state_dict, name="best")
            return True
        if self.trial_counter + 1 < self.num_trials:
            self.trial_counter += 1
            return True
        return False
