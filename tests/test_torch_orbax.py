"""The port's reader of the JAX package's orbax checkpoints
(auformer_torch/core/{ocdbt,orbax_reader,checkpointing}.py) against the
JAX package, orbax and tensorstore.

(a) a tree of every dtype saved by auformer.core.checkpointing.
    save_checkpoint, and by orbax at use_ocdbt=False, read leaf for leaf
    bit-equal to the JAX package's load_checkpoint; the committed fixtures
    of tests/data/orbax/ against expected.json;
(b) the OCDBT layer on stores that tensorstore writes with tiny nodes,
    inline and indirect values and many commits (interior b+tree and
    version-tree nodes): every key, value and version as tensorstore's;
    a bad CRC-32C, an unknown format version or compression raise;
(c) the full-width avformer saved by JAX = state_dict_from_jax of the
    tree, loads strictly, and the port's forward at 32 px = JAX's;
(d) the same round trip for sformer;
(e) the load order of test_aff2 (= the root test_aff2.py's choice) and of
    --resume (train_lib.train);
(f) JAX's target= merge: a dropped array and reshaped ones keep the
    model's values, as JAX keeps them;
(g) fixtures.write_orbax_checkpoint restores through JAX's load_checkpoint;
(h) zarr3, an unknown compressor and filters raise naming them.
"""
import functools
import hashlib
import json
import logging
import os
import shutil
import struct
import sys

import jax
import numpy as np
import pytest
import torch

from auformer.core import checkpointing as jax_ckpt
from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import (convert_avformer, convert_checkpoint,
                                        merge_into)
from auformer.nn import build_model as jax_build_model
from auformer.nn import example_batch as jax_example_batch
from auformer.ops.audio import audio_frontend as jax_frontend
from auformer.ops.preprocess import normalize_clip as jax_normalize_clip
from auformer_torch import test_aff2 as port_test_aff2
from auformer_torch import train_lib
from auformer_torch.core import checkpointing
from auformer_torch.core.config import Config
from auformer_torch.core.ocdbt import OcdbtReader
from auformer_torch.core.orbax_reader import read_orbax_checkpoint
from auformer_torch.core.weights import load_weights, state_dict_from_jax
from auformer_torch.data import native
from auformer_torch.data.fixtures import write_orbax_checkpoint
from auformer_torch.infer import make_infer_fn
from auformer_torch.nn import build_model
from test_torch_import import synthetic_avformer_sd  # noqa: F401 (fixture)

ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "orbax")
sys.path.insert(0, os.path.join(REPO, "scripts"))
from make_orbax_fixtures import leaf_bytes, make_tree  # noqa: E402

RTOL, ATOL = 2e-3, 2e-4   # tests/test_torch_slice.py: full-forward parity
CFG = dict(model_name="avformer", modality="A;V", task="AU", n_frames=16,
           image_size=32, compute_dtype="float32")
SFORMER = dict(model_name="sformer", modality="V", task="AU", n_frames=1,
               dilation=1, image_size=64, compute_dtype="float32")


def flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


def same_leaf(got, want):
    """Bit-equal, dtype and shape included (bfloat16 as its bits)."""
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want)
        assert str(want.dtype) == "bfloat16" and tuple(got.shape) == \
            want.shape
        return got.view(torch.int16).numpy().tobytes() == \
            want.view(np.uint16).tobytes()
    if not isinstance(got, np.ndarray):            # a Python scalar
        return type(got) is type(want) and got == want
    want = np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


def assert_tree_equal(got, want):
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for k in want:
        assert same_leaf(got[k], want[k]), k


def assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.as_tensor(v)), k


# -- (a) ---------------------------------------------------------------------

@pytest.mark.parametrize("ocdbt", [True, False], ids=["ocdbt", "zarr"])
def test_every_dtype_reads_bit_equal_to_jax(tmp_path, ocdbt):
    tree = make_tree(seed=3)
    if ocdbt:
        jax_ckpt.save_checkpoint(str(tmp_path), tree, "best")
    else:
        with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
                use_ocdbt=False)) as c:
            c.save(str(tmp_path / "best"), tree)
    want = jax_ckpt.load_checkpoint(str(tmp_path), "best")
    got = read_orbax_checkpoint(str(tmp_path / "best"))
    assert_tree_equal(got, want)
    assert got["params"]["bf16"].dtype == torch.bfloat16
    assert np.shape(got["params"]["zero_d"]) == ()


@pytest.mark.parametrize("name", ["ocdbt", "zarr"])
def test_committed_fixtures_match_expected_json(name):
    """The bytes in the repository (any orbax version's reader aside):
    each leaf's dtype, shape and SHA-256, and JAX's own restore."""
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        expected = json.load(f)[name]
    got = flat(read_orbax_checkpoint(os.path.join(FIXTURES, name)))
    assert set(got) == set(expected)
    for key, want in expected.items():
        value = got[key]
        assert list(np.shape(value)) == want["shape"], key
        data = leaf_bytes(value.view(torch.int16).numpy()
                          if isinstance(value, torch.Tensor) else value,
                          "int16" if want["dtype"] == "bfloat16" else
                          np.dtype(want["dtype"]).name)
        assert hashlib.sha256(data).hexdigest() == want["sha256"], key
    assert_tree_equal(read_orbax_checkpoint(os.path.join(FIXTURES, name)),
                      jax_ckpt.load_checkpoint(FIXTURES, name))


def test_fixture_holds_inline_indirect_values_and_a_sub_database():
    db = OcdbtReader(os.path.join(FIXTURES, "ocdbt"))
    kinds = {type(v).__name__ for _, v in db.items()}
    assert kinds == {"bytes", "Location"}
    assert {v.file.base_path for _, v in db.items()
            if not isinstance(v, bytes)} == {"ocdbt.process_0/"}
    sub = OcdbtReader(os.path.join(FIXTURES, "ocdbt", "ocdbt.process_0"))
    assert len(sub.versions()) > 1


# -- (b) ---------------------------------------------------------------------

STORES = {
    "tiny_nodes_indirect": dict(max_decoded_node_bytes=150,
                                max_inline_value_bytes=0,
                                version_tree_arity_log2=1),
    "tiny_nodes_inline": dict(max_decoded_node_bytes=200,
                              max_inline_value_bytes=100000,
                              version_tree_arity_log2=2),
    "mixed_uncompressed": dict(max_inline_value_bytes=16,
                               version_tree_arity_log2=1,
                               compression=None),
}


@functools.lru_cache(maxsize=None)
def tensorstore_db(name: str, root: str) -> tuple[str, dict]:
    """A store of ~60 keys over 20 commits of 3 writes and a delete."""
    path = os.path.join(root, name)
    shutil.rmtree(path, ignore_errors=True)
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                             "config": STORES[name]}).result()
    rs = np.random.RandomState(len(name))
    for commit in range(20):
        with ts.Transaction() as txn:
            t = store.with_transaction(txn)
            for _ in range(3):
                key = f"params.k{rs.randint(1000):04d}/{'x' * rs.randint(4)}"
                t[key.encode()] = rs.bytes(rs.randint(0, 80))
            if commit % 5 == 4:
                keys = store.list().result()
                if keys:
                    del t[keys[rs.randint(len(keys))]]
    keys = store.list().result()
    return path, {k: store.read(k).result().value for k in keys}


def ts_generations(path: str) -> list[int]:
    base = ts.KvStore.open(f"file://{path}/").result()
    manifest = ts.ocdbt.dump(base).result()
    gens = [v["generation_number"] for v in manifest["versions"]]
    stack = list(manifest["version_tree_nodes"])
    while stack:
        node = ts.ocdbt.dump(base, stack.pop()["location"]).result()
        if node["height"] == 0:
            gens += [v["generation_number"] for v in node["entries"]]
        else:
            stack += node["entries"]
    return sorted(gens)


@pytest.mark.parametrize("name", sorted(STORES))
def test_ocdbt_reads_what_tensorstore_reads(name, tmp_path_factory):
    path, want = tensorstore_db(name, str(tmp_path_factory.getbasetemp()))
    db = OcdbtReader(path)
    assert db.read_all() == want
    assert db.list() == sorted(want)
    for key, value in want.items():
        assert db.read(key) == value
    assert db.read(b"params.k9999/zz") is None
    assert db.read(b"") is None
    assert [v.generation_number for v in db.versions()] == \
        ts_generations(path)
    if name.startswith("tiny"):
        assert db.version.root_height > 0           # interior nodes
    assert db._version_nodes                     # version-tree nodes
    cfg = STORES[name]
    assert db.config.max_inline_value_bytes == cfg["max_inline_value_bytes"]
    assert db.config.compression == (None if "compression" in cfg
                                     else {"id": "zstd", "level": 0})


def _reencode(data: bytes, version: int = 0, compression: int = 1) -> bytes:
    """``data`` (an encoded manifest) with another format version or
    compression id, its length and CRC-32C made right."""
    head = data[:12]
    body = data[14:-4]
    new = head[:4] + struct.pack("<Q", len(data)) + bytes(
        [version, compression]) + body
    return new + struct.pack("<I", native.crc32c(new))


@pytest.mark.parametrize("fault", ["crc", "version", "compression", "magic"])
def test_ocdbt_faults_raise(fault, tmp_path):
    path, _ = tensorstore_db("tiny_nodes_inline",
                             str(tmp_path.parent.parent))
    db = tmp_path / "db"
    shutil.copytree(path, db)
    manifest = db / "manifest.ocdbt"
    data = manifest.read_bytes()
    data = {"crc": data[:-5] + bytes([data[-5] ^ 1]) + data[-4:],
            "version": _reencode(data, version=1),
            "compression": _reencode(data, compression=7),
            "magic": b"\x0c\xdb\x20\xde" + data[4:]}[fault]
    manifest.write_bytes(data)
    match = {"crc": "CRC-32C", "version": "format version 1",
             "compression": "compression id 7", "magic": "magic"}[fault]
    with pytest.raises(ValueError, match=match):
        OcdbtReader(str(db))


# -- (c) ---------------------------------------------------------------------

def abstract_variables(cfg: dict):
    jcfg = JaxConfig(use_pallas=False, **cfg)
    model = jax_build_model(jcfg)
    abstract = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jax_example_batch(jcfg, batch_size=2))
    return model, dict(abstract)


@pytest.fixture(scope="module")
def avformer_saved(synthetic_avformer_sd, tmp_path_factory):
    model, abstract = abstract_variables(CFG)
    tree = jax.tree_util.tree_map(np.asarray, merge_into(
        abstract, convert_avformer(synthetic_avformer_sd)))
    tree = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    root = tmp_path_factory.mktemp("avformer")
    jax_ckpt.save_checkpoint(str(root), tree, "best")
    return model, tree, str(root)


def test_full_width_avformer_round_trip(avformer_saved,
                                        synthetic_avformer_sd):
    """JAX's save -> the port's load_checkpoint = state_dict_from_jax of
    the tree in memory = the reference state dict; it loads strictly into
    the full-width port model, and its forward = JAX's."""
    jmodel, tree, root = avformer_saved
    sd = checkpointing.load_checkpoint(root, "best", "avformer")
    assert_sd_equal(sd, state_dict_from_jax(tree))
    assert_sd_equal(sd, synthetic_avformer_sd)
    assert len(sd) == 461 - 42          # the BatchNorms' counters aside
    model = build_model(Config(**CFG))
    load_weights(model, sd)             # strict: only counters missing

    rs = np.random.RandomState(7)
    clip = rs.randint(0, 256, (2, 16, 32, 32, 3)).astype(np.uint8)
    audio = (rs.randn(2, 441000) * 0.1).astype(np.float32)
    flen = np.array([1001, 1001], np.int32)
    restored = jax_ckpt.load_checkpoint(root, "best")

    @jax.jit
    def jax_forward(variables, clip, audio, flen):
        x = {"clip": jax_normalize_clip(clip),
             "audio_features": jax_frontend(audio, flen, mel_bf16=True)}
        return jmodel.apply(variables, x, train=False)

    want = np.asarray(jax_forward(restored, clip, audio, flen))
    got = make_infer_fn(Config(**CFG), model, device="cpu")(
        {"clip": clip, "audio": audio, "feature_len": flen})
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# -- (d) ---------------------------------------------------------------------

def seeded_sd(model: torch.nn.Module, seed: int) -> dict:
    from test_torch_zoo import seeded_state_dict
    return {k: torch.from_numpy(v)
            for k, v in seeded_state_dict(model, seed).items()}


@functools.lru_cache(maxsize=None)
def sformer_tree(seed: int):
    """(port model, its seeded state dict, the JAX tree of it)."""
    model = build_model(Config(**SFORMER))
    sd = seeded_sd(model, seed)
    _, abstract = abstract_variables(SFORMER)
    tree = jax.tree_util.tree_map(np.asarray, merge_into(
        abstract, convert_checkpoint("sformer", {
            k: v.numpy() for k, v in sd.items()})))
    return model, sd, {"params": tree["params"],
                       "batch_stats": tree["batch_stats"]}


def test_sformer_round_trip(tmp_path):
    model, sd, tree = sformer_tree(1)
    jax_ckpt.save_checkpoint(str(tmp_path), tree, "best")
    got = checkpointing.load_checkpoint(str(tmp_path), "best", "sformer")
    assert_sd_equal(got, sd)
    assert_sd_equal(got, state_dict_from_jax(tree, "sformer"))
    load_weights(model, got)


# -- (e) ---------------------------------------------------------------------

def tagged(tag: float) -> dict:
    return {"params": {"w": np.full(2, tag, np.float32)},
            "batch_stats": {"m": np.full(1, tag, np.float32)}}


def write_pretrain(root, kinds: tuple) -> str:
    pretrain = os.path.join(root, "experiments", "avformer", "pretrain")
    os.makedirs(pretrain)
    if "best" in kinds:
        jax_ckpt.save_checkpoint(pretrain, tagged(1.0), "best")
    if "latest" in kinds:
        jax_ckpt.save_checkpoint(pretrain, tagged(2.0), "latest")
    if "pth" in kinds:
        torch.save({"w": torch.zeros(2)}, os.path.join(pretrain, "a.pth"))
    return pretrain


def root_choice(monkeypatch, root) -> float:
    """Which checkpoint the root test_aff2.py loads (tag 1 best, 2 latest,
    3 the .pth, 0 random init), its model and its inference stubbed."""
    import auformer.core.torch_import as torch_import
    sys.path.insert(0, REPO)
    import test_aff2 as root_test_aff2

    seen = {}
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "argv", ["test_aff2.py"])
    monkeypatch.setattr(root_test_aff2, "init_model",
                        lambda cfg: (None, tagged(0.0)))
    monkeypatch.setattr(torch_import, "load_torch_state_dict",
                        lambda path: {})
    monkeypatch.setattr(torch_import, "convert_checkpoint",
                        lambda name, sd: tagged(3.0))
    monkeypatch.setattr(root_test_aff2, "run_inference_sweep",
                        lambda cfg, variables, **kw: seen.update(variables))
    root_test_aff2.main()
    return float(np.asarray(seen["params"]["w"])[0])


@pytest.mark.parametrize("kinds", [("best", "latest", "pth"),
                                   ("latest", "pth"), ("pth",), ()],
                         ids=["best", "latest", "pth", "none"])
def test_test_aff2_chooses_as_the_root_one(kinds, tmp_path, monkeypatch,
                                           capsys):
    pretrain = write_pretrain(str(tmp_path), kinds)
    want = root_choice(monkeypatch, str(tmp_path))
    assert want == {"best": 1.0, "latest": 2.0, "pth": 3.0, "none": 0.0}[
        kinds[0] if kinds else "none"]
    capsys.readouterr()
    path = port_test_aff2.checkpoint_path(pretrain)
    got = (0.0 if path is None else 3.0 if path.endswith(".pth")
           else {"best": 1.0, "latest": 2.0}[os.path.basename(path)])
    assert got == want
    # the port's main over the same directory: its lines, its merge
    monkeypatch.setattr(port_test_aff2, "build_model",
                        lambda cfg: torch.nn.Linear(2, 1))
    monkeypatch.setattr(port_test_aff2, "run_inference_sweep",
                        lambda cfg, model, **kw: None)
    port_test_aff2.main([], device="cpu")
    out = capsys.readouterr().out
    if not kinds:
        assert "WARNING: no checkpoint found, using random init" in out
    else:
        rel = os.path.relpath(path, str(tmp_path))
        kind = "torch" if rel.endswith(".pth") else "orbax"
        assert f"restored {kind} checkpoint: {rel}" in out
        assert f"Loading weight from: {port_test_aff2.MODEL_PATH}" in out


class _Stop(Exception):
    pass


def resumed_weights(monkeypatch, exp_dir: str) -> dict:
    """The model's state dict right after train_lib.train's --resume."""
    seen = {}

    def stop(cfg, model, **kw):
        seen.update(checkpointing.model_state_dict(model))
        raise _Stop

    class Data:
        train_ids = np.ones(2)

        def __len__(self):
            return 2

        def set_modes(self, modes):
            pass

    monkeypatch.setattr(train_lib, "create_train_state", stop)
    cfg = Config(**SFORMER, exp_dir=exp_dir, resume=True)
    with pytest.raises(_Stop):
        train_lib.train(cfg, dataset=Data(), device="cpu")
    return seen


def test_resume_prefers_orbax_latest_over_latest_pth(tmp_path, monkeypatch):
    """--resume: the JAX package's latest/ first, latest.pth second (its
    train_lib.py:197-216)."""
    _, sd, tree = sformer_tree(1)
    _, sd_pth, _ = sformer_tree(2)
    pretrain = tmp_path / "pretrain"
    jax_ckpt.save_checkpoint(str(pretrain), tree, "latest")
    checkpointing.save_checkpoint(str(pretrain), sd_pth, "latest")
    got = resumed_weights(monkeypatch, str(tmp_path))
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    shutil.rmtree(pretrain / "latest")
    got = resumed_weights(monkeypatch, str(tmp_path))
    for k, v in sd_pth.items():
        assert torch.equal(got[k], v), k


def test_a_directory_that_is_no_checkpoint_raises(tmp_path):
    """An orbax directory without _METADATA raises, as orbax does: no
    fallback to a .pth or to random weights."""
    (tmp_path / "best").mkdir()
    torch.save({}, tmp_path / "best.pth")
    with pytest.raises(ValueError, match="_METADATA"):
        checkpointing.load_checkpoint(str(tmp_path), "best", "avformer")


# -- (f) ---------------------------------------------------------------------

def test_merge_keeps_dropped_and_reshaped_arrays_as_jax(tmp_path, caplog):
    """The checkpoint lacks one array and holds two at other shapes (one a
    token projection that no longer splits in 12): JAX's
    load_checkpoint(target=) keeps the target's values there and takes
    the rest; the port's merge gives the same state dict and logs each
    kept array."""
    model, sd_model, tree_model = sformer_tree(4)
    _, _, tree = sformer_tree(5)
    tree = jax.tree_util.tree_map(np.copy, tree)
    p = tree["params"]
    del p["base_model"]["stem"]["conv1"]["kernel"]
    p["fc"]["fc2"]["bias"] = np.zeros(5, np.float32)
    kernel = p["au_head"]["token_proj"]["kernel"]
    p["au_head"]["token_proj"]["kernel"] = kernel[:, :-1]
    jax_ckpt.save_checkpoint(str(tmp_path), tree, "latest")

    want = state_dict_from_jax(jax_ckpt.load_checkpoint(
        str(tmp_path), "latest", target=tree_model), "sformer")
    with caplog.at_level(logging.WARNING):
        got = checkpointing.load_checkpoint(str(tmp_path), "latest",
                                            "sformer", target=sd_model)
    assert set(got) == set(sd_model)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    kept = ["base_model.conv1.weight", "fc.3.bias"] + [
        f"au_head.AU_linear_p{i}.weight" for i in range(1, 13)]
    for k in kept:
        assert torch.equal(got[k], sd_model[k]), k
        assert k in caplog.text
    assert torch.equal(got["au_head.AU_linear_p1.bias"],
                       torch.from_numpy(p["au_head"]["token_proj"]["bias"]
                                        [:len(sd_model[
                                            "au_head.AU_linear_p1.bias"])]))
    load_weights(model, got)


# -- (g) ---------------------------------------------------------------------

def test_write_orbax_checkpoint_restores_through_jax(tmp_path):
    rs = np.random.RandomState(11)
    tree = {"params": {"dense": {"kernel": rs.randn(40, 30).astype(
        np.float32), "bias": rs.randn(30).astype(np.float32)},
        "big": rs.randn(70000).astype(np.float32),         # > one block
        "bf": torch.randn(6, 4).bfloat16(),
        "i": rs.randint(0, 9, (5,)).astype(np.int32),
        "zero_d": np.float32(2.5), "empty": np.zeros((0, 3), np.float32)},
        "batch_stats": {"var": rs.rand(30).astype(np.float32)}}
    n = write_orbax_checkpoint(str(tmp_path / "best"), tree)
    assert n > 70000 * 4
    want = {k: (np.asarray(v.float().numpy()) if isinstance(
        v, torch.Tensor) else v) for k, v in flat(tree).items()}
    restored = flat(jax_ckpt.load_checkpoint(str(tmp_path), "best"))
    assert set(restored) == set(want)
    for k, v in want.items():
        got = np.asarray(restored[k])
        if k.endswith("bf"):
            assert str(got.dtype) == "bfloat16"
            got = got.astype(np.float32)
        assert got.dtype == np.asarray(v).dtype and got.shape == np.shape(v)
        assert got.tobytes() == np.asarray(v).tobytes(), k
    assert_tree_equal(read_orbax_checkpoint(str(tmp_path / "best")),
                      jax_ckpt.load_checkpoint(str(tmp_path), "best"))


# -- (h) ---------------------------------------------------------------------

def test_zarr3_raises_naming_it(tmp_path):
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)) as c:
        c.save(str(tmp_path / "best"), {"a": np.arange(3.0)})
    with pytest.raises(ValueError, match="zarr3"):
        read_orbax_checkpoint(str(tmp_path / "best"))


@pytest.mark.parametrize("field,value,match", [
    ("compressor", {"id": "blosc", "cname": "lz4"}, "compressor 'blosc'"),
    ("filters", [{"id": "delta", "dtype": "<f8"}], "filters \\['delta'\\]"),
    ("dtype", ">f4", "dtype '>f4'"),
    ("order", "F", "order 'F'"),
])
def test_unsupported_zarr_raises_naming_it(tmp_path, field, value, match):
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
            use_ocdbt=False)) as c:
        c.save(str(tmp_path / "best"), {"a": np.arange(6.0).reshape(2, 3)})
    zarray = tmp_path / "best" / "a" / ".zarray"
    meta = json.loads(zarray.read_text())
    meta[field] = value
    zarray.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=match):
        read_orbax_checkpoint(str(tmp_path / "best"))
