"""A data-parallel dry run on the CPU (the port's counterpart of the root
``__graft_entry__.py``'s ``dryrun_multichip``):

    python -m auformer_torch.dryrun [N]

spawns a gloo world of N processes (default 2; ``parallel/multiproc.py``),
each of which runs one data-parallel avformer train step (32x32, T=2,
fp32, a global batch of 8) and one eval step with the rows gathered, and
prints three lines: the train loss, the gathered eval rows' shape with the
eval loss, and that ``host_shard`` gave the ranks disjoint, equal shards.
It exits non-zero when a worker fails or a check does not hold.
"""
from __future__ import annotations

import sys
import tempfile

import numpy as np

from .parallel.multiproc import spawn_workers

BATCH = 8


def dryrun(n: int) -> None:
    with tempfile.TemporaryDirectory() as out:
        spawn_workers(out, n, ["--batch", str(BATCH)])
        recs = [np.load(f"{out}/avformer_r{r}.npz") for r in range(n)]
        losses = {float(r["loss"]) for r in recs}
        rows = recs[0]["eval_rows"]
        if len(losses) != 1 or not np.isfinite(rows).all() or any(
                not np.array_equal(r["eval_rows"], rows) for r in recs):
            raise RuntimeError(f"dryrun({n}): the ranks disagree: losses "
                               f"{losses}")
        print(f"dryrun({n}): train loss={losses.pop():.4f} world={n}")
        print(f"dryrun({n}): eval rows={rows.shape} "
              f"loss={float(recs[0]['eval_loss']):.4f}")
        shards = [list(s) for s in recs[0]["all_ids"]]
        flat = [i for s in shards for i in s]
        if len(set(flat)) != len(flat) or len({len(s) for s in shards}) != 1:
            raise RuntimeError(f"dryrun({n}): host_shard gave {shards}")
        print(f"dryrun({n}): host_shard {n}x{len(shards[0])} disjoint, "
              f"local batch={int(recs[0]['local_batch'])} ok")


if __name__ == "__main__":
    dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
