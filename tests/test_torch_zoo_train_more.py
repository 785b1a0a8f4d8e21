"""Training the model zoo in auformer_torch against the JAX package, on the
CPU, continued from tests/test_torch_zoo_train.py (whose helpers it
uses), so that the two run on two test workers: one fp32 train step of
i3d, sformer and tsav against JAX's, and the train entry point on the
port's fixtures for mc3d, its checkpoint loaded into JAX.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import convert_checkpoint, merge_into
from auformer.nn import build_model as jax_build_model
from auformer.nn import example_batch as jax_example_batch
from auformer_torch import train as train_entry
from auformer_torch.core.weights import load_reference_state_dict
from auformer_torch.data.fixtures import generate_synthetic_dataset
from test_torch_zoo_train import (  # noqa: F401 (fixture)
    STEP_CASES, STEP_MODELS, check_train_step, stable_flax_variance)


@pytest.mark.parametrize(
    "case", sorted(set(STEP_MODELS) - set(STEP_CASES)))
def test_zoo_train_step_matches_jax(case, stable_flax_variance):
    check_train_step(case)


# -- the train entry point -----------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("zoo_train")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=3,
                               frames_per_video=[30, 30, 20], image_size=32,
                               splits=["train", "val", "test"], n_threads=2)
    return base, root, labels


def test_train_entry_point_trains_a_zoo_model(fixture_dirs):
    """``python -m auformer_torch.train --device_augment --model_name
    <zoo model>`` (its ``main`` with device="cpu") on the port's fixtures:
    two epochs with finite losses and scores, ``latest.pth`` in the
    reference layout, which JAX's ``convert_checkpoint`` + ``merge_into``
    turn into a concrete variables tree whose logits equal the trained
    port model's."""
    base, root, labels = fixture_dirs
    name, modality = "mc3d", "V"
    argv = ["--root", root, "--lmdb_label_dir", labels,
            "--cache_dir", str(base / "cache"),
            "--exp_dir", str(base / f"exp_{name}"), "--model_name", name,
            "--modality", modality, "--n_frames", "4", "--image_size", "32",
            "--batch_size", "4", "--downsample_rate", "2", "--epochs", "2",
            "--device_augment", "--compute_dtype", "float32",
            "--host_threads", "2", "--seed", "7"]
    state, history = train_entry.main(argv, device="cpu")
    assert [h["epoch"] for h in history] == [0, 1]
    assert state.step == sum(h["steps"] for h in history) > 0
    for h in history:
        assert np.isfinite(h["loss"]) and np.isfinite(h["score"])
    path = base / f"exp_{name}" / "pretrain" / "latest.pth"
    sd = {k: v.numpy() for k, v in load_reference_state_dict(
        str(path)).items() if not k.endswith("num_batches_tracked")}
    cfg = dict(model_name=name, modality=modality, task="AU", n_frames=4,
               image_size=32, compute_dtype="float32")
    jcfg = JaxConfig(use_pallas=False, **cfg)
    model = jax_build_model(jcfg)
    abstract = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jax_example_batch(jcfg, batch_size=2))
    variables = merge_into(dict(abstract), convert_checkpoint(name, sd))
    assert all(isinstance(leaf, np.ndarray)
               for leaf in jax.tree_util.tree_leaves(variables))
    x = jax_example_batch(jcfg, batch_size=2, rng=np.random.RandomState(74))
    want = np.asarray(jax.jit(functools.partial(model.apply, train=False))(
        variables, x))
    trained = state.model.eval()
    with torch.no_grad():
        got = trained({k: torch.from_numpy(v) for k, v in x.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
