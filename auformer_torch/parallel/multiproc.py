"""Data-parallel processes on one machine (counterpart of
auformer/parallel/multiproc.py).

``spawn_workers`` starts N fresh ``python -m auformer_torch.parallel.
multiproc`` processes with a process group's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), gloo on the CPU
or on one shared card, NCCL on one card per process. Each runs
``worker_main``: it joins the group, builds each model from a seed of its
own (rank 0's weights, or a reference-layout ``.pth``, reach the others
only through the broadcast), takes its rows of one global batch
(``make_global_table``, ``shard_batch``), runs one data-parallel train step
and one eval step whose rows are gathered, and writes what a check needs
to ``{out_dir}/{model}_r{rank}.npz``: the loss, every trainable
parameter's first Adam moment (0.1 x its gradient plus the L2 term), the
BatchNorm statistics, the gathered eval rows and loss, its ids and every
rank's, the step's wall ms and the collectives it counted. With
``serve``, also ``run_inference_sweep`` over ``synthetic_videos`` with the
videos spread over the ranks, rank 0 writing ``{out_dir}/results_r0``.

A worker that exits non-zero fails the launch, whatever files it wrote
(the JAX package's launcher forgives a worker whose result file is
there); one that fails stops the others at once, rather than leaving them
in a collective until its timeout.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_global_table(n_rows: int, n_frames: int, size: int,
                      seed: int = 0) -> dict:
    """The global batch every process (and the check) derives alike:
    uint8 clips, host audio features and labels; each process loads its
    disjoint rows of it."""
    rs = np.random.RandomState(seed)
    return {
        "clip": rs.randint(0, 256, (n_rows, n_frames, size, size, 3)
                           ).astype(np.uint8),
        "audio_features": rs.randn(n_rows, 1, 64, 1001).astype(np.float32),
        "AU": rs.randint(0, 2, (n_rows, 12)).astype(np.float32),
        "EX": rs.randint(0, 7, (n_rows, 1)).astype(np.int32),
        "VA": rs.uniform(-1, 1, (n_rows, 2)).astype(np.float32),
    }


def synthetic_videos(n_videos: int, n_frames: int, size: int,
                     seed: int = 0) -> list[dict]:
    """``run_inference_sweep`` items: uint8 frames, a mono wav one second
    longer than the video, 30 fps timestamps, consecutive dataset rows."""
    rs = np.random.RandomState(seed)
    out, start = [], 0
    for v in range(n_videos):
        n = n_frames + 7 * v
        out.append({
            "video_id": f"video{v}", "Index": np.arange(start, start + n),
            "frames": rs.randint(0, 256, (n, size, size, 3), dtype=np.uint8),
            "wav": (rs.randn((n // 30 + 1) * 44100) * 0.1).astype(np.float32),
            "timestamps_ms": np.arange(n) * 1000.0 / 30.0})
        start += n
    return out


def model_config(name: str, **overrides):
    """The Config of one zoo model for a data-parallel check: avformer
    ("A;V") or a visual model ("V"), task AU, fp32 unless overridden."""
    from ..core.config import Config
    modality = "A;V" if name == "avformer" else "V"
    fields = dict(model_name=name, modality=modality, task="AU",
                  compute_dtype="float32", lr_schedule=False)
    fields.update(overrides)
    return Config(**fields)


def build_replica(cfg, mesh, seed: int, weights: str | None = None):
    """The model on the mesh's device with rank 0's weights everywhere:
    each rank initializes from ``seed + rank`` (and rank 0 loads the
    reference-layout ``weights`` when given), then rank 0 broadcasts."""
    from ..core.weights import load_reference_state_dict, load_weights
    from ..nn import build_model
    torch.manual_seed(seed + mesh.rank)
    model = build_model(cfg, dtype=torch.float32)
    if weights and mesh.rank == 0:
        load_weights(model, load_reference_state_dict(weights))
    model.to(mesh.device)
    mesh.broadcast_module(model)
    return model


def step_record(state, model) -> dict:
    """The first Adam moment of every trainable parameter (``g/<name>``)
    and every floating buffer (``s/<name>``: BatchNorm statistics), as
    numpy copies (later steps update the tensors in place)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for p in state.params:
        moment = state.optimizer.state.get(p, {}).get("exp_avg")
        if moment is not None:
            out["g/" + names[id(p)]] = moment.detach().cpu().numpy().copy()
    for n, b in model.named_buffers():
        if b.is_floating_point():
            out["s/" + n] = b.detach().cpu().numpy().copy()
    return out


def sharded_step(mesh, cfg, table: dict, seed: int = 0,
                 weights: str | None = None, timed_steps: int = 0) -> dict:
    """One eval step of ``cfg``'s model on this rank's rows of the global
    ``table`` (the gathered (B_global, 21) rows and the global loss), then
    one data-parallel train step on them (the step generator seeded with
    ``seed`` on every rank) and its record (``step_record``). The eval
    comes first: Adam's first update moves each weight by about the rate
    whatever the size of its gradient, which would carry the reduction
    order's noise into the rows. With ``timed_steps``, that many more
    steps, timed (``step_ms``, wall ms per step after a device sync)."""
    from ..core.mesh import shard_batch
    from ..nn import loss_suite
    from . import create_train_state, make_eval_step, make_train_step
    model = build_replica(cfg, mesh, seed, weights)
    suite = loss_suite(model)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, suite, mesh)
    local = shard_batch(mesh, table)
    rows, eval_loss = make_eval_step(cfg, model, suite, mesh)(local)
    gen = torch.Generator(device=mesh.device)
    metrics = step(state, local, gen.manual_seed(seed))
    rec = {"loss": float(metrics["loss"]), "eval_rows": rows.cpu().numpy(),
           "eval_loss": float(eval_loss), **step_record(state, model)}
    if timed_steps:
        sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
                else lambda: None)
        sync()
        t0 = time.perf_counter()
        for i in range(timed_steps):
            step(state, local, gen.manual_seed(seed + 1 + i))
        sync()
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3 / timed_steps
    return rec


def world_one_step(cfg, table: dict, device, seed: int = 0,
                   weights: str | None = None) -> dict:
    """The step of ``sharded_step`` in one process without a process
    group, on the whole global ``table``: what a world of N must
    reproduce."""
    from ..core.mesh import shard_batch
    from ..core.weights import load_reference_state_dict, load_weights
    from ..nn import build_model, loss_suite
    from . import create_train_state, make_eval_step, make_train_step
    torch.manual_seed(seed)
    model = build_model(cfg, dtype=torch.float32)
    if weights:
        load_weights(model, load_reference_state_dict(weights))
    model.to(device)
    suite = loss_suite(model)
    state = create_train_state(cfg, model)
    batch = shard_batch(None, table, device)
    rows, eval_loss = make_eval_step(cfg, model, suite)(batch)
    metrics = make_train_step(cfg, model, suite)(
        state, batch, torch.Generator(device=device).manual_seed(seed))
    return {"loss": float(metrics["loss"]), "eval_rows": rows.cpu().numpy(),
            "eval_loss": float(eval_loss), **step_record(state, model)}


def worker_main(port: int, rank: int, world: int, out_dir: str,
                backend: str = "gloo", device: str = "cpu",
                models: tuple[str, ...] = ("avformer",), image_size: int = 32,
                n_frames: int = 2, batch: int = 8, dropout: float = 0.2,
                device_augment: bool = True, timed_steps: int = 0,
                serve: int = 0, seed: int = 0) -> None:
    """One process of the world (the module docstring): joins the group
    on ``device`` over ``backend``, then for each of ``models`` one
    sharded step and eval on a global batch of ``batch`` rows at
    ``image_size`` x ``n_frames``, written to ``{model}_r{rank}.npz``;
    with ``serve`` > 0 the fp32 sweep over two synthetic videos of
    ``serve`` and ``serve`` + 7 frames too (``sweep_r{rank}.npy``)."""
    from ..core.mesh import make_mesh, maybe_init_distributed
    from ..train_lib import host_shard
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    os.environ.setdefault("LOCAL_RANK", str(rank))
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    # the records are held against an fp32 step: no TF32 (cuDNN's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_init_distributed(dev, backend)
    import torch.distributed as dist
    try:
        mesh = make_mesh("data:-1", dev)
        table = make_global_table(batch, n_frames, image_size, seed)
        ids, local_bs = host_shard(list(range(2 * batch)), batch)
        all_ids = mesh.gather_objects(ids)
        os.makedirs(out_dir, exist_ok=True)
        for name in models:
            cfg = model_config(name, image_size=image_size,
                               n_frames=n_frames, batch_size=batch,
                               dropout_rate=dropout,
                               device_augment=device_augment)
            before = dict(mesh.counts)
            rec = sharded_step(mesh, cfg, table, seed,
                               timed_steps=timed_steps)
            counts = {k: v - before.get(k, 0)
                      for k, v in mesh.counts.items()}
            np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"),
                     ids=np.asarray(ids), all_ids=np.asarray(all_ids),
                     local_batch=local_bs,
                     collectives=np.asarray(str(counts)), **rec)
            print(f"multiproc worker {rank}/{world} {name}: loss="
                  f"{rec['loss']:.4f} rows={rec['eval_rows'].shape}",
                  flush=True)
        if serve:
            from ..infer import run_inference_sweep
            from ..nn import build_model
            cfg = model_config("avformer", image_size=image_size,
                               n_frames=n_frames)
            torch.manual_seed(seed + rank)
            out = run_inference_sweep(
                cfg, build_model(cfg), synthetic_videos(2, serve, image_size,
                                                        seed),
                os.path.join(out_dir, f"results_r{rank}"), device=dev,
                mesh=mesh)
            np.save(os.path.join(out_dir, f"sweep_r{rank}.npy"), out)
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_workers(out_dir: str, world: int, args: list[str] = (),
                  command: list[str] | None = None,
                  port: int | None = None) -> list:
    """Start ``world`` processes of ``command`` (default: this module)
    with ``PORT RANK WORLD OUT_DIR *args`` and the process group's
    environment; each writes its output to ``{out_dir}/worker{rank}.log``.
    ``wait_workers`` collects them."""
    port = port or free_port()
    command = command or [sys.executable, "-m",
                          "auformer_torch.parallel.multiproc"]
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        log = open(os.path.join(out_dir, f"worker{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [*command, str(port), str(rank), str(world), out_dir, *args],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO), log))
    return procs


def wait_workers(procs: list, timeout: float = 900.0) -> list[str]:
    """Wait for ``start_workers``' processes; returns each one's output.
    A worker that exits non-zero, or the timeout, kills the others and
    raises with that worker's output."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"multiproc: workers still running after "
                                   f"{timeout:.0f} s")
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    outs = []
    for p, log in procs:
        with open(log.name) as f:
            outs.append(f.read())
    if bad:
        i = bad[0]
        raise RuntimeError(f"multiproc worker {i} exited with "
                           f"{procs[i][0].returncode}:\n{outs[i][-4000:]}")
    return outs


def spawn_workers(out_dir: str, world: int = 2, args: list[str] = (),
                  timeout: float = 900.0, command: list[str] | None = None
                  ) -> list[str]:
    """``start_workers`` then ``wait_workers``."""
    return wait_workers(start_workers(out_dir, world, args, command),
                        timeout)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("port", type=int)
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("out_dir")
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    p.add_argument("--device", default="cpu")
    p.add_argument("--models", default="avformer")
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--n_frames", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--no_device_augment", dest="device_augment",
                   action="store_false")
    p.add_argument("--timed_steps", type=int, default=0)
    p.add_argument("--serve", type=int, default=0,
                   help="frames of the first of two swept videos (0: none)")
    a = p.parse_args(argv)
    worker_main(a.port, a.rank, a.world, a.out_dir, a.backend, a.device,
                tuple(a.models.split(",")), a.image_size, a.n_frames,
                a.batch, a.dropout, a.device_augment, a.timed_steps, a.serve)


if __name__ == "__main__":
    main()
