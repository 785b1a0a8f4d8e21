"""auformer_torch.quickstart (the port's examples/quickstart.py) on the CPU.

One dataset, written once for the module by the quickstart's own
``make_dataset`` (the port's fixtures: four videos of 40 frames, 64x64,
train, train, val, test), read by both packages:

  * the quickstart's inference step against the JAX package's
    ``run_inference`` on the same ``Config`` and the same weights (JAX's
    ``init_model`` at seed 0, carried into the port by
    ``state_dict_from_jax``): predictions within rtol 2e-3 / atol 2e-4, the
    same submission files and line counts, and every row whose AU logits
    all lie more than 1e-3 from the threshold (logit 0) written alike;
  * ``main(["--cpu", ...])`` end to end: 2 epochs, finite losses, an AU
    score, the submission files;
  * ``main([])`` without a GPU raises; it never falls back to the CPU.
"""
import os

import jax
import numpy as np
import pytest
import torch

from auformer.core.config import Config as JaxConfig
from auformer.infer import run_inference as jax_run_inference
from auformer.nn import init_model
from auformer_torch import quickstart
from auformer_torch.core.weights import load_weights, state_dict_from_jax
from auformer_torch.nn import build_model

RTOL, ATOL = 2e-3, 2e-4
THRESHOLD_MARGIN = 1e-3   # logits this close to 0 may round either way
TEST_FRAMES = 40          # the test split: the fourth video


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread: the train loop runs loader and prefetch threads
    beside torch's pool, which would oversubscribe the cores beside the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("quickstart"))
    quickstart.make_dataset(base)
    return base


def _jax_config(cfg):
    """The JAX package's Config with the same fields as the port's."""
    fields = set(JaxConfig.__dataclass_fields__)
    return JaxConfig(**{k: v for k, v in vars(cfg).items() if k in fields})


def _au_files(result_dir: str) -> dict:
    au = os.path.join(result_dir, "au")
    out = {}
    for name in sorted(os.listdir(au)):
        with open(os.path.join(au, name)) as f:
            out[name] = f.read().splitlines()
    return out


def test_quickstart_config_is_the_jax_scripts(work):
    """examples/quickstart.py's Config fields, on the work directory."""
    cfg = quickstart.quickstart_config(work)
    assert (cfg.model_name, cfg.modality, cfg.task) == ("vformer", "V", "AU")
    assert (cfg.n_frames, cfg.dilation, cfg.image_size, cfg.batch_size,
            cfg.downsample_rate, cfg.epochs, cfg.eval_batch_mult,
            cfg.compute_dtype, cfg.use_pallas) == (
        4, 2, 64, 8, 1, 2, 1, "float32", False)
    assert cfg.root == os.path.join(work, "root")
    assert cfg.exp_dir == os.path.join(work, "exp")


def test_inference_matches_jax(work, tmp_path):
    cfg = quickstart.quickstart_config(work)
    jcfg = _jax_config(cfg)
    _, variables = init_model(jcfg, seed=0)
    want_dir = str(tmp_path / "jax" / "results")
    want = jax_run_inference(jcfg, variables, result_path=want_dir)

    model = build_model(cfg)
    load_weights(model, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), "vformer"))
    got = quickstart.infer(cfg, model, str(tmp_path / "port"), "cpu")
    got_dir = str(tmp_path / "port" / "results")

    assert got.shape == want.shape == (4 * TEST_FRAMES, 21)
    assert np.abs(got).sum(axis=1).astype(bool).sum() == TEST_FRAMES
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    got_files, want_files = _au_files(got_dir), _au_files(want_dir)
    assert list(got_files) == list(want_files) == ["vid003.txt"]
    rows = np.flatnonzero(np.abs(want).sum(axis=1))   # the test rows, in order
    for name, lines in got_files.items():
        assert len(lines) == len(want_files[name]) == TEST_FRAMES + 1
        assert lines[0] == want_files[name][0]
        clear = np.abs(want[rows, :12]).min(axis=1) > THRESHOLD_MARGIN
        assert clear.any()
        for i in np.flatnonzero(clear):
            assert lines[i + 1] == want_files[name][i + 1], i
    assert os.path.isfile(os.path.join(got_dir, "inference.pkl"))


def test_main_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    history, predictions, work = quickstart.main(
        ["--cpu", "--workdir", str(tmp_path)])
    assert work == str(tmp_path)
    assert [h["epoch"] for h in history] == [0, 1]
    for h in history:
        assert np.isfinite(h["loss"]) and h["steps"] > 0
        assert np.isfinite(h["scores"]["AU"]["score"])
    assert predictions.shape == (4 * TEST_FRAMES, 21)
    assert np.isfinite(predictions).all()
    files = _au_files(str(tmp_path / "results"))
    assert list(files) == ["vid003.txt"]
    assert len(files["vid003.txt"]) == TEST_FRAMES + 1
    assert (tmp_path / "results" / "inference.pkl").is_file()
    assert (tmp_path / "exp" / "pretrain" / "latest.pth").is_file()
    said = capsys.readouterr().out.splitlines()
    assert said[0] == f"workdir: {tmp_path}"
    assert [line for line in said if line.startswith("  epoch ")] == [
        f"  epoch {h['epoch']}: loss {h['loss']:.4f} "
        f"AU score {h['scores']['AU']['score']:.4f}" for h in history]
    assert said[-1].startswith("inference: (160, 21) predictions")


def test_main_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
