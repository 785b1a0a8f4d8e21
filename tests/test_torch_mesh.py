"""auformer_torch's process-group runtime (core/mesh.py) in one process,
against the JAX package where it has a counterpart.

  * ``parse_mesh_shape`` against JAX's over specs and their errors, and
    ``data_world``'s refusal of a ``model`` axis;
  * ``host_shard`` against JAX's for worlds 1-4, and a batch that does
    not divide;
  * ``maybe_init_distributed``'s two branches (``init_process_group``
    replaced), ``make_mesh`` without a group, ``process_group_scope``;
  * the cross-replica BatchNorm and the global draws over a mesh of one
    rank whose collectives are the identity: equal to the local paths.

The worlds of two processes are in ``test_torch_multiproc.py``.
"""
import collections

import numpy as np
import pytest
import torch
import torch.distributed as dist

from auformer.core.mesh import parse_mesh_shape as jax_parse_mesh_shape
from auformer.train_lib import host_shard as jax_host_shard
from auformer_torch import train_lib
from auformer_torch.core import mesh as mesh_lib
from auformer_torch.nn.blocks import (BatchNorm1d, BatchNorm2d, BatchNorm3d,
                                      Dropout, DropPath,
                                      set_dropout_generator, set_step_mesh)
from auformer_torch.ops.augment_device import policy_draws
from auformer_torch.ops.preprocess import random_flip_clips

SPECS = [("data:-1", 8), ("data:-1", 1), ("data:4,model:2", 8),
         ("data:-1,model:2", 8), ("model:2,data:-1", 4), ("data:2", 2),
         ("data", 6), ("data:-1,model:-1", 8), ("data:-1,model:3", 8),
         ("data:3,model:1", 3), ("data:-1,model:1", 5)]


@pytest.mark.parametrize("spec,n", SPECS)
def test_parse_mesh_shape_matches_jax(spec, n):
    try:
        want = jax_parse_mesh_shape(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            mesh_lib.parse_mesh_shape(spec, n)
        return
    assert mesh_lib.parse_mesh_shape(spec, n) == want


def test_data_world_takes_the_whole_world_on_data():
    assert mesh_lib.data_world("data:-1", 4) == 4
    assert mesh_lib.data_world("data:-1,model:1", 3) == 3
    with pytest.raises(ValueError, match="model"):
        mesh_lib.data_world("data:-1,model:2", 4)
    with pytest.raises(ValueError, match="data=2 of 4"):
        mesh_lib.data_world("data:2", 4)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_host_shard_matches_jax(world):
    ids = list(np.random.RandomState(world).permutation(103))
    shards = []
    for rank in range(world):
        got = train_lib.host_shard(ids, 12, host_id=rank, num_hosts=world)
        want = jax_host_shard(ids, 12, host_id=rank, num_hosts=world)
        assert got == (list(want[0]), want[1])
        shards.append(got[0])
    flat = [i for s in shards for i in s]
    assert len(set(flat)) == len(flat) == world * (103 // world)
    assert len({len(s) for s in shards}) == 1


def test_host_shard_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="not divisible by 4"):
        train_lib.host_shard(list(range(40)), 10, host_id=0, num_hosts=4)
    # without a process group: one process, every id
    assert train_lib.host_shard([3, 1, 2], 10) == ([3, 1, 2], 10)


def test_maybe_init_distributed_branches(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert mesh_lib.maybe_init_distributed("cpu") is False
    assert calls == []
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    assert mesh_lib.maybe_init_distributed("cpu") is True
    assert calls == [(("gloo",), {"init_method": "env://", "rank": 1,
                                  "world_size": 2})]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert mesh_lib.maybe_init_distributed("cpu") is True
    assert len(calls) == 1


def test_pad_to_multiple_matches_jax():
    from auformer.core.mesh import pad_to_multiple as jax_pad
    for n, m in ((0, 8), (1, 8), (8, 8), (9, 8), (17, 4), (5, 1)):
        assert mesh_lib.pad_to_multiple(n, m) == jax_pad(n, m)


def test_test_videos_shard_by_video():
    """serve._test_videos under a mesh: video i to rank i mod N, after
    max_clips cut the leading videos (what sweep_stream and
    packed_sweep_stream stream on each rank)."""
    from auformer_torch.serve import _test_videos

    class Split:
        test_ids = np.array([1, 1, 1, 0, 1, 1, 1, 1, 1, 1])
        video_db_nr = np.array([3, 3, 5, 5, 7, 7, 7, 9, 11, 11])

    rows, videos, counts = _test_videos(Split())
    assert videos == [3, 5, 7, 9, 11] and counts == [2, 1, 3, 1, 2]
    for max_clips, kept in ((None, 5), (4, 3)):
        shards = []
        for rank in range(2):
            mesh = mesh_lib.Mesh(rank=rank, world=2, local_rank=rank,
                                 device=torch.device("cpu"), backend="none")
            _, v, c = _test_videos(Split(), mesh, max_clips)
            assert c == [counts[videos.index(x)] for x in v]
            shards.append(v)
        assert shards[0] == videos[:kept][0::2]
        assert shards[1] == videos[:kept][1::2]


def test_no_group_means_no_mesh():
    assert not dist.is_initialized()
    assert mesh_lib.make_mesh("data:-1", "cpu") is None
    with mesh_lib.process_group_scope():
        pass
    mesh_lib.check_mesh(None)
    with pytest.raises(TypeError, match="Mesh"):
        mesh_lib.check_mesh(object())


class IdentityMesh(mesh_lib.Mesh):
    """A mesh of one rank whose collectives are the identity (no process
    group): the cross-replica paths' arithmetic in one process."""

    def __init__(self):
        super().__init__(rank=0, world=1, local_rank=0,
                         device=torch.device("cpu"), backend="none",
                         counts=collections.Counter())

    def all_reduce(self, t, kind="all_reduce"):
        self._count(kind, t)
        return t


@pytest.mark.parametrize("cls,shape", [(BatchNorm1d, (6, 5)),
                                       (BatchNorm1d, (4, 5, 3)),
                                       (BatchNorm2d, (4, 3, 5, 6)),
                                       (BatchNorm3d, (2, 3, 4, 5, 3))])
def test_cross_replica_batchnorm_equals_local(cls, shape):
    """Forward, input/weight/bias gradients and the flax running
    statistics of the cross-replica path at world 1 = the local path."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32) * 2 + 0.5)
    ct = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    outs = []
    for mesh in (None, IdentityMesh()):
        bn = cls(shape[1]).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                               .manual_seed(1))
            bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator()
                             .manual_seed(2))
        xi = x.clone().requires_grad_(True)
        set_step_mesh(bn, mesh)
        y = bn(xi)
        (y * ct).sum().backward()
        outs.append((y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean.clone(), bn.running_var.clone(),
                     int(bn.num_batches_tracked)))
        if mesh is not None:
            assert mesh.counts["batch_norm"] == 3   # sums, squares, backward
    for a, b in zip(*outs):
        if isinstance(a, int):
            assert a == b
        else:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_global_draws_at_world_one_are_the_local_draws():
    """draw_rows at world 1 and without a mesh draw the same numbers:
    the dropout masks, the flip and the AutoAugment draws."""
    mesh = IdentityMesh()
    x = torch.ones(6, 5, 4)
    for cls in (Dropout, DropPath):
        got = []
        for m in (None, mesh):
            drop = cls(0.5).train()
            set_dropout_generator(drop, torch.Generator().manual_seed(4))
            set_step_mesh(drop, m)
            got.append(drop(x))
        assert torch.equal(*got)
    clip = torch.rand(4, 2, 3, 3, 3)
    assert torch.equal(
        random_flip_clips(clip, torch.Generator().manual_seed(5)),
        random_flip_clips(clip, torch.Generator().manual_seed(5), mesh=mesh))
    for a, b in zip(policy_draws(4, 3, torch.Generator().manual_seed(6),
                                 "cpu"),
                    policy_draws(4, 3, torch.Generator().manual_seed(6),
                                 "cpu", mesh)):
        assert torch.equal(a, b)


def test_draw_rows_takes_this_ranks_rows_of_the_global_draw():
    """Rank r of N draws the global batch's numbers and keeps rows
    [r*b, (r+1)*b) along the batch axis."""
    full = torch.rand((2, 8, 3), generator=torch.Generator().manual_seed(9))
    for rank in range(4):
        mesh = mesh_lib.Mesh(rank=rank, world=4, local_rank=rank,
                             device=torch.device("cpu"), backend="none")
        got = mesh_lib.draw_rows(
            lambda s: torch.rand(s, generator=torch.Generator()
                                 .manual_seed(9)), (2, 2, 3), mesh, dim=1)
        assert torch.equal(got, full[:, 2 * rank:2 * rank + 2])
