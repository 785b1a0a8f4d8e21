"""auformer_torch data parallel over processes: one spawned gloo world of
two CPU workers (this file's ``worker``), held against the world-1 step in
this process and against the JAX package's sharded step.

  * avformer and vformer (32x32, T=2, fp32, a global batch of 8, dropout
    0.2, ``device_augment``): both ranks agree on the loss and the gathered
    eval rows, their ids are disjoint, and world 2 equals the world-1 step
    on the global batch within ``tests/test_parallel.py``'s tolerances
    (loss rel 1e-5; gradients rtol 5e-3 / atol 5e-5, which a factor of N
    fails; running statistics < 1e-4);
  * avformer at ``test_torch_train.py``'s step settings (T=16, dropout 0,
    symmetric clips, the synthetic reference weights): equal to JAX's
    ``make_train_step`` on conftest's 8-device mesh at that file's
    tolerances;
  * the cross-replica BatchNorm at world 2: forward, backward and the
    biased running variance = local BatchNorm on the concatenated batch;
  * rank 1's different seed is overwritten by rank 0's broadcast;
  * ``--steps_per_dispatch 2`` under gloo at world 2 raises;
  * ``train.main(..., device="cpu")`` for one epoch on each rank: equal
    histories, the same downsampled ids sharded disjointly, one
    ``latest.pth`` that JAX's ``convert_checkpoint`` loads, the validation
    rows gathered;
  * ``run_inference_sweep`` at world 2 = world 1, its files written once;
  * ``test_aff2.main`` (the clip path, ``run_inference`` over a test split
    of two videos) at world 2 = world 1;
  * ``python -m auformer_torch.dryrun 2`` prints its three lines.

Every worker keeps torch at one intra-op thread.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from auformer_torch import train as train_entry
from auformer_torch import train_lib
from auformer_torch.core.config import Config
from auformer_torch.core.mesh import make_mesh, maybe_init_distributed
from auformer_torch.infer import run_inference_sweep
from auformer_torch.nn import build_model, loss_suite
from auformer_torch.nn.blocks import BatchNorm1d, BatchNorm2d, set_step_mesh
from auformer_torch.parallel import make_multi_train_step
from auformer_torch.parallel import multiproc as mp
from test_torch_import import synthetic_avformer_sd  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
GLOBAL_BATCH = 8
SMALL = dict(image_size=32, n_frames=2, batch_size=GLOBAL_BATCH,
             dropout_rate=0.2, device_augment=True)
# tests/test_torch_train.py's STEP_CFG at a global batch of 8 (one row per
# device of the JAX package's 8-device mesh)
JAX_STEP_CFG = dict(model_name="avformer", modality="A;V", task="AU",
                    n_frames=16, image_size=32, compute_dtype="float32",
                    dropout_rate=0.0, batch_size=GLOBAL_BATCH,
                    learning_rate=1e-3)
SWEEP_CFG = dict(model_name="avformer", modality="A;V", task="AU",
                 n_frames=4, dilation=2, image_size=32,
                 compute_dtype="float32")
SWEEP_FRAMES, SWEEP_BUCKET = 12, 8    # two videos, of 12 and 19 frames
# tests/test_parallel.py
LOSS_REL, GRAD_TOL, STATS_ATOL = 1e-5, (5e-3, 5e-5), 1e-4
# tests/test_torch_train.py
JAX_LOSS_TOL = JAX_GRAD_TOL = (2e-3, 2e-4)
JAX_STATS_TOL = (1e-3, 1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def symmetric_batch(n: int, seed: int = 10) -> dict:
    """test_torch_train.py's batch at n rows: left-right symmetric clips
    (the flip is the identity), host features, labels with ignored cells."""
    rs = np.random.RandomState(seed)
    half = rs.randint(0, 256, (n, 16, 32, 16, 3)).astype(np.uint8)
    au = rs.randint(0, 2, (n, 12)).astype(np.int8)
    au[1, 0] = -1
    au[2, 5] = -1
    return {"clip": np.concatenate([half, half[:, :, :, ::-1]], axis=3),
            "audio_features": rs.randn(n, 1, 64, 1001).astype(np.float32),
            "AU": au, "EX": rs.randint(-1, 7, (n, 1)).astype(np.int8),
            "VA": rs.uniform(-1, 1, (n, 2)).astype(np.float32)}


def train_argv(spec: dict) -> list[str]:
    return ["--root", spec["root"], "--lmdb_label_dir", spec["labels"],
            "--cache_dir", spec["cache"], "--exp_dir", spec["exp"],
            "--image_size", "32", "--n_frames", "4", "--batch_size", "4",
            "--downsample_rate", "2", "--epochs", "1", "--device_augment",
            "--device_audio", "--compute_dtype", "float32",
            "--host_threads", "1", "--seed", "7"]


def aff2_argv(spec: dict) -> list[str]:
    return ["--root", spec["root"], "--lmdb_label_dir", spec["labels"],
            "--cache_dir", spec["cache"], "--image_size", "32",
            "--n_frames", "4", "--batch_size", "4",
            "--compute_dtype", "float32", "--host_threads", "1"]


def run_test_aff2(spec: dict, cwd: str):
    """``test_aff2.main`` on the clip path (``AUFORMER_SWEEP=0``) in
    ``cwd``, which receives ``results/``; the prediction matrix."""
    from auformer_torch import test_aff2
    here = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    os.environ["AUFORMER_SWEEP"] = "0"
    try:
        return test_aff2.main(aff2_argv(spec), device="cpu")
    finally:
        del os.environ["AUFORMER_SWEEP"]
        os.chdir(here)


def _save(out: str, name: str, rank: int, **arrays) -> None:
    np.savez(os.path.join(out, f"{name}_r{rank}.npz"), **arrays)


def _batchnorm_errors(mesh) -> dict:
    """Cross-replica BatchNorm over this rank's rows against local
    BatchNorm over the whole global batch: max abs errors of the output
    rows, input gradient rows, the (all-reduced) weight and bias gradients
    and the running statistics."""
    errs = {}
    for cls, shape in ((BatchNorm2d, (8, 3, 5, 4)), (BatchNorm1d, (8, 6))):
        rs = np.random.RandomState(5)
        x = torch.from_numpy(rs.randn(*shape).astype(np.float32) * 2 + 0.5)
        ct = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        rows = mesh.rows(shape[0] // mesh.world)
        got, want = [], []
        for m, xs, cs, acc in ((mesh, x[rows], ct[rows], got),
                               (None, x, ct, want)):
            bn = cls(shape[1]).train()
            with torch.no_grad():
                bn.weight.copy_(torch.linspace(0.5, 1.5, shape[1]))
                bn.bias.copy_(torch.linspace(-0.5, 0.5, shape[1]))
            xi = xs.clone().requires_grad_(True)
            set_step_mesh(bn, m)
            y = bn(xi)
            (y * cs).sum().backward()
            acc += [y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                    bn.running_mean, bn.running_var]
        for g in got[2:4]:
            mesh.all_reduce(g)               # the step's gradient SUM
        want[0], want[1] = want[0][rows], want[1][rows]
        for key, a, b in zip(("y", "dx", "dweight", "dbias", "mean", "var"),
                             got, want):
            errs[f"{cls.__name__}_{key}"] = float((a - b).abs().max())
    return errs


def worker(argv: list[str]) -> None:
    """One rank of the world: every case of this file, written to
    ``{out}/*_r{rank}.npz``."""
    port, rank, world, out = int(argv[0]), int(argv[1]), int(argv[2]), \
        argv[3]
    with open(argv[4]) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    assert maybe_init_distributed(cpu)
    mesh = make_mesh("data:-1", cpu)
    table = mp.make_global_table(GLOBAL_BATCH, 2, 32, 0)
    ids, local_bs = train_lib.host_shard(list(range(40)), GLOBAL_BATCH)
    for name in ("avformer", "vformer"):
        rec = mp.sharded_step(mesh, mp.model_config(name, **SMALL), table)
        _save(out, name, rank, ids=ids, all_ids=mesh.gather_objects(ids),
              local_batch=local_bs, **rec)
    rec = mp.sharded_step(mesh, Config(**JAX_STEP_CFG),
                          symmetric_batch(GLOBAL_BATCH), weights=spec["pth"])
    _save(out, "jax_settings", rank, **rec)

    # the broadcast: each rank's seed differs, rank 0's weights win
    torch.manual_seed(100 + rank)
    model = build_model(mp.model_config("vformer", **SMALL))
    with torch.no_grad():
        before = float(sum(p.double().sum() for p in model.parameters()))
        mesh.broadcast_module(model)
        after = float(sum(p.double().sum() for p in model.parameters()))
    try:
        make_multi_train_step(mp.model_config("vformer", **SMALL), model,
                              loss_suite(model), 2, mesh)
        refusal = ""
    except ValueError as e:
        refusal = str(e)
    _save(out, "checks", rank, before=mesh.gather_objects(before),
          after=mesh.gather_objects(after), refusal=refusal,
          **_batchnorm_errors(mesh))

    # train.main for one epoch, counting the gathered validation rows
    gathered = []
    gather = train_lib._gather_eval_rows

    def counting(batch, m):
        labels = gather(batch, m)
        gathered.append((len(batch["AU"]), len(labels["AU"])))
        return labels

    shards = []
    shard = train_lib.host_shard

    def recording(ids, batch_size):
        local, local_bs = shard(ids, batch_size)
        shards.append((sorted(int(i) for i in ids), [int(i) for i in local]))
        return local, local_bs

    train_lib._gather_eval_rows = counting
    train_lib.host_shard = recording
    _, history = train_entry.main(train_argv(spec), device="cpu")
    train_lib._gather_eval_rows = gather
    train_lib.host_shard = shard
    _save(out, "train", rank, gathered=np.asarray(gathered),
          shards=json.dumps(shards),
          history=json.dumps([{k: h[k] for k in ("loss", "score", "scores",
                                                  "steps")}
                              for h in history], default=float))

    torch.manual_seed(200 + rank)
    cfg = Config(**SWEEP_CFG)
    sweep = run_inference_sweep(
        cfg, build_model(cfg), mp.synthetic_videos(2, SWEEP_FRAMES, 32, 3),
        os.path.join(out, f"results_r{rank}"), bucket=SWEEP_BUCKET,
        device="cpu", mesh=mesh)
    _save(out, "sweep", rank, rows=sweep)
    _save(out, "aff2", rank, rows=run_test_aff2(spec, os.path.join(out,
                                                                   "aff2")))
    mesh.barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory, synthetic_avformer_sd):
    """Starts the two workers at once (they run while the tests compute
    the references); ``world["wait"]()`` returns {name: [rank 0, rank 1]}
    records."""
    from auformer_torch.data.fixtures import generate_synthetic_dataset
    base = tmp_path_factory.mktemp("multiproc")
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=5,
                               frames_per_video=[40, 40, 40, 20, 14],
                               image_size=32, n_threads=2,
                               splits=["train", "train", "val", "test",
                                       "test"])
    pth = str(base / "weights.pth")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in synthetic_avformer_sd.items()}, pth)
    spec = {"pth": pth, "root": root, "labels": labels,
            "cache": str(base / "cache"), "exp": str(base / "exp")}
    spec_file = base / "spec.json"
    spec_file.write_text(json.dumps(spec))
    out = str(base / "out")
    code = (f"import sys; sys.path[:0] = [{REPO!r}, {HERE!r}]; "
            "import test_torch_multiproc as t; t.worker(sys.argv[1:])")
    procs = mp.start_workers(out, WORLD, [str(spec_file)],
                             command=[sys.executable, "-c", code])
    done = {}

    def wait():
        if not done:
            mp.wait_workers(procs, timeout=1200)
            for name in ("avformer", "vformer", "jax_settings", "checks",
                         "train", "sweep", "aff2"):
                done[name] = [dict(np.load(f"{out}/{name}_r{r}.npz"))
                              for r in range(WORLD)]
        return done

    yield {"wait": wait, "spec": spec, "out": out}
    mp.wait_workers(procs, timeout=1200)


def _close(got: dict, want: dict, rtol, atol, stats_atol) -> None:
    assert {k for k in got if k[:2] in ("g/", "s/")} == \
        {k for k in want if k[:2] in ("g/", "s/")}
    for key, value in want.items():
        if key.startswith("g/"):
            np.testing.assert_allclose(got[key], value, rtol=rtol,
                                       atol=atol, err_msg=key)
        elif key.startswith("s/"):
            assert np.abs(got[key] - value).max() < stats_atol, key


@pytest.mark.parametrize("name", ["avformer", "vformer"])
def test_world_two_equals_world_one(world, name):
    """Dropout 0.2 and the device AutoAugment on: the ranks agree, their
    shards are disjoint, and the step is the world-1 step on the global
    batch: loss, gradients (a factor of 2 fails them), BatchNorm
    statistics, gathered eval rows and loss."""
    cfg = mp.model_config(name, **SMALL)
    want = mp.world_one_step(cfg, mp.make_global_table(GLOBAL_BATCH, 2, 32,
                                                       0), "cpu")
    ranks = world["wait"]()[name]
    assert float(ranks[0]["loss"]) == float(ranks[1]["loss"])
    np.testing.assert_array_equal(ranks[0]["eval_rows"],
                                  ranks[1]["eval_rows"])
    shards = [set(r["ids"].tolist()) for r in ranks]
    assert not shards[0] & shards[1]
    assert [set(s) for s in ranks[0]["all_ids"].tolist()] == shards
    assert int(ranks[0]["local_batch"]) == GLOBAL_BATCH // WORLD
    for got in ranks:
        assert float(got["loss"]) == pytest.approx(want["loss"],
                                                   rel=LOSS_REL)
        _close(got, want, *GRAD_TOL, STATS_ATOL)
        assert got["eval_rows"].shape == (GLOBAL_BATCH, 21)
        np.testing.assert_allclose(got["eval_rows"], want["eval_rows"],
                                   rtol=1e-4, atol=1e-5)
        assert float(got["eval_loss"]) == pytest.approx(want["eval_loss"],
                                                        rel=LOSS_REL)
    g = [k for k in want if k.startswith("g/")]
    assert any(np.abs(want[k]).max() > 1e-3 for k in g)


def test_world_two_equals_jax_sharded_step(world):
    """avformer at test_torch_train.py's step settings: the world-2 step's
    loss, fusion-head first Adam moments and BatchNorm statistics against
    JAX's make_train_step on the 8-device mesh (same weights, same
    batch)."""
    import jax

    from auformer.core.config import Config as JaxConfig
    from auformer.core.mesh import make_mesh as jax_make_mesh
    from auformer.core.mesh import shard_batch as jax_shard_batch
    from auformer.core.torch_import import convert_avformer, merge_into
    from auformer.nn import build_model as jax_build_model
    from auformer.nn import example_batch, loss_suite as jax_loss_suite
    from auformer.parallel import step as jstep
    from auformer_torch.core.weights import Exporter, state_dict_from_jax
    from auformer_torch.core.weights import load_reference_state_dict

    cfg = JaxConfig(use_pallas=False, **JAX_STEP_CFG)
    model = jax_build_model(cfg)
    abstract = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0),
                            "dropout": jax.random.PRNGKey(1)},
                           example_batch(cfg, batch_size=2), train=False))
    sd = load_reference_state_dict(world["spec"]["pth"])
    variables = merge_into(dict(abstract), convert_avformer(
        {k: v.numpy() for k, v in sd.items()}))
    mesh = jax_make_mesh("data:-1")
    assert mesh.shape["data"] == 8
    state = jstep.create_train_state(cfg, model, variables)
    step = jstep.make_train_step(cfg, model, jax_loss_suite(model), mesh,
                                 donate=False)
    state, metrics = step(state, jax_shard_batch(
        mesh, symmetric_batch(GLOBAL_BATCH)), jax.random.PRNGKey(0))
    adam = [s for s in state.opt_state.inner_states["train"].inner_state
            if hasattr(s, "mu")][0]
    e = Exporter({"params": {"au_head": jax.tree_util.tree_map(
        np.asarray, adam.mu["au_head"])}})
    e.former_au_head("au_head", "au_head")
    stats = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))

    for got in world["wait"]()["jax_settings"]:
        np.testing.assert_allclose(float(got["loss"]),
                                   float(metrics["loss"]), *JAX_LOSS_TOL)
        assert set(e.sd) == {k[2:] for k in got if k.startswith("g/")}
        for key, want in e.sd.items():
            np.testing.assert_allclose(got["g/" + key], want.numpy(),
                                       *JAX_GRAD_TOL, err_msg=key)
        for key, want in stats.items():
            if "running_" in key:
                np.testing.assert_allclose(got["s/" + key], want.numpy(),
                                           *JAX_STATS_TOL, err_msg=key)


def test_batchnorm_broadcast_and_graph_refusal(world):
    """The cross-replica BatchNorm = local BatchNorm on the concatenated
    batch (forward, backward, biased running variance); rank 1's own seed
    gave other weights until rank 0's broadcast; K = 2 under gloo at
    world 2 raises naming the reason."""
    for got in world["wait"]()["checks"]:
        errs = {k: float(v) for k, v in got.items()
                if k.startswith("BatchNorm")}
        assert len(errs) == 12 and max(errs.values()) < 1e-5, errs
        before, after = got["before"], got["after"]
        assert before[0] != before[1]
        assert after[0] == after[1] == before[0]
        assert "gloo" in str(got["refusal"]) \
            and "captured" in str(got["refusal"])


def test_train_main_at_world_two(world):
    """One epoch of train.main on each rank: the same history, one
    latest.pth (rank 0's) that the JAX package loads, the validation rows
    gathered from both ranks."""
    import jax

    from auformer.core.config import Config as JaxConfig
    from auformer.core.torch_import import (convert_checkpoint,
                                            load_torch_state_dict,
                                            merge_into)
    from auformer.nn import build_model as jax_build_model
    from auformer.nn import example_batch

    ranks = world["wait"]()["train"]
    histories = [json.loads(str(r["history"])) for r in ranks]
    assert histories[0] == histories[1]
    # the train and val ids each rank shards: the same downsampled ids on
    # both (np.random.shuffle of the mask, seeded alike), disjoint shards
    shards = [json.loads(str(r["shards"])) for r in ranks]
    assert len(shards[0]) == 2
    for (ids0, local0), (ids1, local1) in zip(*shards):
        assert ids0 == ids1 and ids0
        assert not set(local0) & set(local1)
        assert len(local0) == len(local1) == len(ids0) // WORLD
    assert len(histories[0]) == 1 and histories[0][0]["steps"] > 0
    assert np.isfinite(histories[0][0]["loss"])
    for r in ranks:
        gathered = r["gathered"]
        assert len(gathered) > 0
        assert (gathered[:, 1] == WORLD * gathered[:, 0]).all()
    pretrain = os.path.join(world["spec"]["exp"], "pretrain")
    assert sorted(os.listdir(pretrain)) == ["best.pth", "latest.pth"]
    path = os.path.join(pretrain, "latest.pth")
    cfg = JaxConfig(use_pallas=False, **dict(JAX_STEP_CFG, n_frames=4))
    model = jax_build_model(cfg)
    abstract = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0),
                            "dropout": jax.random.PRNGKey(1)},
                           example_batch(cfg, batch_size=2), train=False))
    merged = merge_into(dict(abstract), convert_checkpoint(
        "avformer", load_torch_state_dict(path)))
    assert all(isinstance(leaf, np.ndarray)
               for leaf in jax.tree_util.tree_leaves(merged))


def test_video_sharded_sweep_equals_world_one(world, tmp_path):
    """run_inference_sweep over two videos at world 2 (one each) = world 1
    row for row; rank 0 alone wrote the files, the same as world 1's."""
    cfg = Config(**SWEEP_CFG)
    torch.manual_seed(200)
    want = run_inference_sweep(cfg, build_model(cfg),
                               mp.synthetic_videos(2, SWEEP_FRAMES, 32, 3),
                               str(tmp_path / "results"), bucket=SWEEP_BUCKET,
                               device="cpu")
    out = world["out"]
    for got in world["wait"]()["sweep"]:
        np.testing.assert_allclose(got["rows"], want, rtol=1e-4, atol=1e-5)
    assert not os.path.exists(os.path.join(out, "results_r1"))
    for video in ("video0", "video1"):
        with open(os.path.join(out, "results_r0", "au",
                               video + ".txt")) as f:
            got = f.read()
        assert got == (tmp_path / "results" / "au"
                       / (video + ".txt")).read_text()
    with open(os.path.join(out, "results_r0", "inference.pkl"), "rb") as f:
        import pickle
        np.testing.assert_allclose(pickle.load(f)["predictions"], want,
                                   rtol=1e-4, atol=1e-5)


def test_test_aff2_shards_the_test_split_by_video(world, tmp_path):
    """test_aff2.main on the clip path at world 2 (the split's two test
    videos, one per rank) = world 1: the prediction matrix on both ranks,
    and rank 0's submission files."""
    want = run_test_aff2(world["spec"], str(tmp_path))
    for got in world["wait"]()["aff2"]:
        np.testing.assert_allclose(got["rows"], want, rtol=1e-4, atol=1e-5)
    assert np.abs(want).sum(axis=1).astype(bool).sum() == 34   # 20 + 14
    got_dir = os.path.join(world["out"], "aff2", "results", "au")
    names = sorted(os.listdir(tmp_path / "results" / "au"))
    assert len(names) == 2 and sorted(os.listdir(got_dir)) == names
    for name in names:
        with open(os.path.join(got_dir, name)) as f:
            assert f.read() == (tmp_path / "results" / "au"
                                / name).read_text()


def test_dryrun_prints_its_three_lines():
    proc = subprocess.run([sys.executable, "-m", "auformer_torch.dryrun",
                           "2"], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun(2):")]
    assert len(lines) == 3, proc.stdout
    assert "train loss=" in lines[0]
    assert "eval rows=(8, 21)" in lines[1]
    assert "host_shard 2x" in lines[2] and "disjoint" in lines[2]
