"""auformer_torch's packed cross-video serving (packed.py) on the CPU:
against the JAX package's ``packed_sweep_stream`` and against the port's own
per-video ``serve.sweep_stream``.

The fixture of tests/test_packed.py: 5 test videos x 21 frames, 32x32, T=4,
dilation 2, 1 s of audio (windows cut by the end of the file), fp32. One
seeded port initialisation loads into both packages; logits are held at
rtol 2e-3 / atol 2e-4 (tests/test_torch_serve.py).
"""
import functools
import mmap
import os

import jax
import numpy as np
import pytest
import torch

from auformer import sweep as jax_sweep_module
from auformer.core.config import Config as JaxConfig
from auformer.core.torch_import import convert_avformer, merge_into
from auformer.data.fixtures import generate_synthetic_dataset
from auformer.nn import build_model as jax_build_model
from auformer.nn import example_batch
from auformer.packed import packed_sweep_stream as jax_packed_sweep_stream
from auformer_torch import serve
from auformer_torch.core.config import Config
from auformer_torch.data import Aff2TestDataset
from auformer_torch.nn import build_model
from auformer_torch.packed import (ArenaFull, ArenaReleases, FrameArena,
                                   packed_sweep_stream)
from auformer_torch.sweep import AvformerSweep

RTOL, ATOL = 2e-3, 2e-4
CFG = dict(model_name="avformer", modality="A;V", task="AU", n_frames=4,
           dilation=2, image_size=32, compute_dtype="float32",
           batch_size=8, host_threads=2)


def _dirs(base, n_videos, audio_secs=1.0):
    root, labels = str(base / "root"), str(base / "labels")
    generate_synthetic_dataset(root, labels, n_videos=n_videos,
                               frames_per_video=21, image_size=32,
                               audio_secs=audio_secs, fps=30.0,
                               splits=["test"])
    return dict(root=root, lmdb_label_dir=labels,
                cache_dir=str(base / "cache"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The split, the port's seeded weights in both packages (JAX's through
    ``convert_avformer`` over the model's abstract init tree, nothing
    compiled), and the port's per-video stream through a decode thread."""
    dirs = _dirs(tmp_path_factory.mktemp("packed"), 5)
    jcfg = JaxConfig(use_pallas=False, **dirs, **CFG)
    cfg = Config(**dirs, **CFG)
    torch.manual_seed(0)
    model = build_model(cfg)
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    abstract = jax.eval_shape(
        functools.partial(jax_build_model(jcfg).init, train=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(jcfg, batch_size=2))
    variables = merge_into(dict(abstract), convert_avformer(sd))
    sweep = AvformerSweep(cfg, model, device="cpu")
    ref = list(serve.sweep_stream(cfg, model, dataset=Aff2TestDataset(cfg),
                                  bucket=16, sweep=sweep,
                                  decode_worker=False))
    assert len(ref) == 5
    return dict(cfg=cfg, jcfg=jcfg, variables=variables, model=model,
                sweep=sweep, ref=ref)


def _packed(setup, bucket, **kw):
    stats = {}
    out = list(packed_sweep_stream(
        setup["cfg"], setup["model"], dataset=Aff2TestDataset(setup["cfg"]),
        bucket=bucket, sweep=setup["sweep"], stats=stats, **kw))
    return out, stats


def _assert_same(got, want, n_videos=None):
    """The same videos in the same order, the same rows and ids, logits
    within the tolerance."""
    want = want[:n_videos]
    assert [v for _, v, _ in got] == [v for _, v, _ in want]
    for (gi, _, gl), (wi, _, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gl.shape == (len(wi), 12) and gl.dtype == np.float32
        np.testing.assert_allclose(gl, np.asarray(wl), rtol=RTOL, atol=ATOL)


def test_packed_matches_jax(setup):
    """bucket 16 over 5 x 21 clips (joins inside buckets, a partial flush)
    against JAX's packed stream with the same weights."""
    jcfg = setup["jcfg"]
    from auformer.data.testset import Aff2TestDataset as JaxTestset
    want = list(jax_packed_sweep_stream(
        jcfg, setup["variables"], dataset=JaxTestset(jcfg), bucket=16,
        sweep=jax_sweep_module.AvformerSweep(jcfg, setup["variables"]),
        decode_worker=False))
    got, stats = _packed(setup, 16, decode_worker=False)
    _assert_same(got, want)
    assert stats["clips"] == 105 and stats["rows_padded"] == 0
    assert stats["buckets"] == 7 and stats["rows_dispatched"] == 105


@pytest.mark.parametrize("bucket,max_clips,n_videos", [
    (16, None, 5), (512, None, 5), (16, 30, 2)])
def test_packed_matches_per_video(setup, bucket, max_clips, n_videos):
    """Buckets of 16 (the ring of 4 x 16 + 2 x 8 frames wraps), one bucket
    of 512 that packs every video (a flush), and max_clips 30, which keeps
    whole videos until they hold 30 clips."""
    got, stats = _packed(setup, bucket, max_clips=max_clips,
                         decode_worker=False)
    _assert_same(got, setup["ref"], n_videos)
    assert stats["arena"]["frames"] == 4 * bucket + 16
    assert stats["arena"]["backing"] == "memfd"
    assert not stats["arena"]["registered"]
    assert stats["releases"]["made"] == stats["buckets"]
    if bucket == 16 and max_clips is None:
        assert sum(stats["chunk_copy_bytes"]) > 0      # a ring wrap
        assert stats["chunk_copy_bytes"][0] == 0


def test_sweep_serve_benchmark_drives_the_packed_stream(setup):
    """``sweep_serve_benchmark(packed=True)`` labels every test frame
    through the packed stream and returns its statistics."""
    res = serve.sweep_serve_benchmark(
        setup["cfg"], setup["model"], dataset=Aff2TestDataset(setup["cfg"]),
        bucket=16, sweep=setup["sweep"], decode_worker=False, packed=True)
    assert res["clips"] == 105 and res["clips_per_sec"] > 0
    assert res["stats"]["buckets"] == 7 and "arena" in res["stats"]


def test_packed_through_the_decode_worker(setup):
    """A spawned DecodeWorker decodes slices straight into the shared ring
    (attach_arena, request_slice, slice_result): the thread's logits."""
    worker = serve.DecodeWorker(setup["cfg"])
    try:
        got, stats = _packed(setup, 16, decode_worker=worker)
        assert stats["decode_worker"] is worker
        assert stats["decode_seconds"] > 0
        # the same worker serves the per-video protocol afterwards
        worker.request(np.unique(Aff2TestDataset(setup["cfg"]).video_db_nr)[0])
        assert len(worker.result()[0]) == 21
    finally:
        worker.close()
    assert not worker._proc.is_alive()
    _assert_same(got, setup["ref"])


def test_packed_fallback_video(tmp_path_factory, setup):
    """A video whose jittered timestamps need more than max_phases hop-grid
    phases takes the per-video route alone; its neighbours still pack. Its
    frames sit 6 s into an 8 s wav, where the windows' offsets are past 0
    (before 5 s every offset is 0: one phase)."""
    dirs = _dirs(tmp_path_factory.mktemp("packed_fb"), 3, audio_secs=8.0)
    rs = np.random.RandomState(7)
    ts = 6000.0 + np.arange(21) * 1000.0 / 30.0 + rs.uniform(0, 9.9, 21)
    with open(os.path.join(dirs["root"], "vid001_video_ts.txt"), "w") as f:
        f.write("# timestamp format v2\n")
        f.writelines(f"{t:.6f}\n" for t in ts)
    cfg = Config(**dirs, **CFG)
    sweep = AvformerSweep(cfg, setup["model"], device="cpu")
    want = list(serve.sweep_stream(cfg, setup["model"],
                                   dataset=Aff2TestDataset(cfg), bucket=16,
                                   sweep=sweep, decode_worker=False))
    stats = {}
    got = list(packed_sweep_stream(cfg, setup["model"],
                                   dataset=Aff2TestDataset(cfg), bucket=16,
                                   sweep=sweep, decode_worker=False,
                                   stats=stats))
    _assert_same(got, want)
    # the fallback video: 21 clips in two per-video buckets of 16; the ring
    # holds it whole
    assert stats["rows_padded"] == 2 * 16 - 21
    assert stats["fallback_videos"] == 1
    assert stats["arena"]["frames"] == 21 + 3 * 16 + 16


def _fill(arena, g_lo, n):
    base = arena.alloc(g_lo, n)
    arena.buf[base:base + n] = np.arange(g_lo, g_lo + n,
                                         dtype=np.uint8)[:, None, None, None]
    return base


def test_frame_arena_ring():
    """A ring-contiguous range is a view of the ring, a wrapped one an
    assembled copy; overwriting the live backlog raises."""
    arena = FrameArena(10, 2, 2)
    try:
        _fill(arena, 0, 4)
        _fill(arena, 4, 4)
        got = arena.chunk(1, 7)
        np.testing.assert_array_equal(got[:, 0, 0, 0], np.arange(1, 7))
        assert np.shares_memory(got, arena.buf) and arena.copied_bytes == 0
        arena.release_below(6)
        assert _fill(arena, 8, 4) == 0          # 8 + 4 > 10: wraps to 0
        got = arena.chunk(6, 10)
        np.testing.assert_array_equal(got[:, 0, 0, 0], [6, 7, 8, 9])
        assert not np.shares_memory(got, arena.buf)
        assert arena.copied_bytes == got.nbytes
        with pytest.raises(ArenaFull):
            arena.alloc(12, 8)
    finally:
        arena.close()


def test_frame_arena_shared_backing():
    """The ring lives in shared memory that another mapping of its fd
    sees (the decode worker maps it so)."""
    arena = FrameArena(4, 2, 2)
    try:
        assert arena.backing == "memfd"
        other = mmap.mmap(os.dup(arena.fd), arena.nbytes)
        view = np.frombuffer(other, np.uint8).reshape(4, 2, 2, 3)
        arena.buf[1, 0, 0, 0] = 7
        assert view[1, 0, 0, 0] == 7
        view[2, 1, 1, 2] = 9
        assert arena.buf[2, 1, 1, 2] == 9
        del view
        other.close()
    finally:
        arena.close()
    assert arena.buf is None


class _FakeEvent:
    def __init__(self):
        self.done = False
        self.waited = False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True
        self.done = True


def test_arena_releases_are_fifo_and_event_gated():
    """No row is released while its copy's event is pending; a later
    completed copy never releases before an earlier pending one; the
    blocking path waits on the oldest only."""
    arena = FrameArena(32, 1, 1)
    try:
        for g in range(0, 24, 8):
            _fill(arena, g, 8)
        releases = ArenaReleases(arena)
        first, second, third = _FakeEvent(), _FakeEvent(), _FakeEvent()
        releases.push(first, 4)
        releases.push(second, 12)
        releases.push(third, 20)
        second.done = third.done = True
        assert not releases.reap() and arena._free_g == 0
        assert releases.released == 0
        assert releases.reap(block=True)
        assert first.waited and arena._free_g == 20
        assert (releases.released, releases.blocked) == (3, 1)
        releases.push(None, 24)                 # a CPU copy: already done
        assert releases.reap() and arena._free_g == 24
        with pytest.raises(ValueError):
            releases.push(_FakeEvent(), 8)      # a watermark going back
    finally:
        arena.close()


def test_arena_releases_poll_in_order():
    arena = FrameArena(8, 1, 1)
    try:
        _fill(arena, 0, 8)
        releases = ArenaReleases(arena)
        first, second = _FakeEvent(), _FakeEvent()
        releases.push(first, 3)
        releases.push(second, 6)
        first.done = True
        assert releases.reap() and arena._free_g == 3
        assert not releases.reap() and arena._free_g == 3
        second.done = True
        releases.drain()
        assert arena._free_g == 6 and releases.blocked == 0
    finally:
        arena.close()


def test_packed_refusals(setup):
    with pytest.raises(TypeError, match="Mesh"):
        next(packed_sweep_stream(setup["cfg"], setup["model"],
                                 mesh=object(), device="cpu"))
    with pytest.raises(ValueError, match="use serve.sweep_stream"):
        next(packed_sweep_stream(setup["cfg"], setup["model"],
                                 dataset=Aff2TestDataset(setup["cfg"]),
                                 sweep=torch.nn.Identity(), device="cpu"))
