"""Write the orbax checkpoint fixtures of tests/data/orbax/ and what the
JAX package reads from them (expected.json), plus the leaf list of its
full-width avformer (avformer_tree.json).

Needs the JAX package and orbax. Run from the root of the repository:

    python scripts/make_orbax_fixtures.py [--out tests/data/orbax]

Files:
  ocdbt/     auformer.core.checkpointing.save_checkpoint of TREE: an OCDBT
             database at the top (one b+tree leaf in d/) over the
             sub-database ocdbt.process_0/ (its values, four versions);
             values up to 1024 bytes inline, larger ones in data files
  zarr/      the same tree saved by orbax with use_ocdbt=False: a zarr v2
             directory per leaf (its scalars saved as Python numbers)

TREE holds a leaf of every dtype the port reads (<f4 <f8 <f2 <i4 <i8 |u1
|b1 bfloat16), a 0-d array and a Python scalar, a random 64x64 float32
(zstd's Huffman literals) and a repetitive 96x96 one (its matches).

expected.json: for each checkpoint and leaf (its key path joined with
"/"), the zarr dtype, the shape and the SHA-256 of the C-order bytes that
the JAX package's load_checkpoint restores (bfloat16 as its bits, a
Python number as the leaf's dtype).

avformer_tree.json: each leaf of the JAX avformer's {"params",
"batch_stats"} at full width (112x112, T=16), from the abstract init:
its key path, shape and dtype.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import shutil
import sys

import numpy as np

ZARR_DTYPES = {"float32": "<f4", "float64": "<f8", "float16": "<f2",
               "int32": "<i4", "int64": "<i8", "uint8": "|u1",
               "bool": "|b1", "bfloat16": "bfloat16"}


def make_tree(seed: int = 0) -> dict:
    import jax.numpy as jnp

    rs = np.random.RandomState(seed)
    return {
        "params": {
            "dense": {"kernel": rs.randn(24, 16).astype(np.float32),
                      "bias": rs.randn(16).astype(np.float32)},
            "random64": rs.randn(64, 64).astype(np.float32),
            "repetitive96": np.tile(np.arange(24, dtype=np.float32),
                                    (96, 4)),
            "f8": rs.randn(5, 3),
            "f2": rs.randn(4, 4).astype(np.float16),
            "i4": rs.randint(-1000, 1000, (7,)).astype(np.int32),
            "i8": rs.randint(-2**40, 2**40, (2, 3)).astype(np.int64),
            "u1": rs.randint(0, 256, (3, 5)).astype(np.uint8),
            "b1": rs.rand(9) > 0.5,
            "bf16": jnp.asarray(rs.randn(6, 5), dtype=jnp.bfloat16),
            "zero_d": np.float32(1.5),
        },
        "batch_stats": {"mean": rs.randn(16).astype(np.float32),
                        "var": (1 + rs.rand(16)).astype(np.float32)},
        "step": 7,
    }


def leaf_bytes(value, dtype: str) -> bytes:
    arr = np.asarray(value)
    if dtype == "bfloat16":
        return arr.view(np.uint16).tobytes()
    return np.asarray(arr, dtype=np.dtype(dtype)).tobytes()


def describe(tree, dtypes: dict, path=()) -> dict:
    """{key path: {dtype, shape, sha256}} of a restored tree."""
    out = {}
    for k, v in tree.items():
        p = path + (str(k),)
        if isinstance(v, dict):
            out.update(describe(v, dtypes, p))
            continue
        dtype = dtypes[p]
        out["/".join(p)] = {
            "dtype": ZARR_DTYPES[dtype], "shape": list(np.shape(v)),
            "sha256": hashlib.sha256(leaf_bytes(v, dtype)).hexdigest()}
    return out


def source_dtypes(tree, path=()) -> dict:
    out = {}
    for k, v in tree.items():
        p = path + (str(k),)
        if isinstance(v, dict):
            out.update(source_dtypes(v, p))
        else:
            out[p] = str(np.asarray(v).dtype) if not isinstance(
                v, int) else "int64"
    return out


def avformer_tree() -> list[dict]:
    import jax

    from auformer.core.config import Config
    from auformer.nn import build_model, example_batch

    cfg = Config(model_name="avformer", modality="A;V", task="AU",
                 image_size=112, n_frames=16, use_pallas=False)
    model = build_model(cfg)
    abstract = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(cfg, batch_size=2))
    leaves = []
    for col in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(abstract[col])[0]
        for keys, leaf in flat:
            leaves.append({"path": [col] + [k.key for k in keys],
                           "shape": list(leaf.shape),
                           "dtype": str(leaf.dtype)})
    return leaves


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("tests", "data", "orbax"))
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import orbax.checkpoint as ocp

    from auformer.core.checkpointing import load_checkpoint, save_checkpoint

    tree = make_tree()
    dtypes = source_dtypes(tree)
    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out)
    save_checkpoint(args.out, tree, "ocdbt")
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)) as c:
        c.save(os.path.abspath(os.path.join(args.out, "zarr")), tree)
    expected = {}
    for name in ("ocdbt", "zarr"):
        restored = load_checkpoint(args.out, name)
        expected[name] = describe(restored, dtypes)
    with open(os.path.join(args.out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
    with open(os.path.join(args.out, "avformer_tree.json"), "w") as f:
        json.dump(avformer_tree(), f, indent=0)
    total = sum(os.path.getsize(os.path.join(r, n))
                for r, _, files in os.walk(args.out) for n in files)
    print(f"wrote {args.out}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
