"""``parallel.TrainCheckpoint`` of the port, on the CPU.

* A step restored from a checkpoint continues bit for bit: 3 steps of a
  small ResNet V1 (SGD with momentum and a FactorScheduler, so the
  update count matters), saved, restored into a fresh net and step, one
  more step, equal to the 4th step of an uninterrupted run (losses,
  parameters, moving statistics, momenta), and the random generator's
  state comes back with it.
* Bookkeeping: ``max_to_keep``, ``async_save`` with ``wait``, the
  context manager; a truncated or garbage epoch fails the structural
  check (``latest_epoch`` skips it) and raises ``MXNetError`` naming
  its epoch and path on restore.
* The JAX package's API on an empty directory (restore -1, no tree, no
  extra, latest -1) and its tree round trip with ``extra``, held against
  the JAX ``TrainCheckpoint`` (orbax) on the same numpy tree.
"""
import os

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                              ResNetV1)
from incubator_mxnet_tpu_torch.gluon.nn._modules import (
    SoftmaxCrossEntropyLoss)
from incubator_mxnet_tpu_torch.lr_scheduler import FactorScheduler
from incubator_mxnet_tpu_torch.optimizer import SGD
from incubator_mxnet_tpu_torch.parallel import TrainCheckpoint, TrainStep

NET = dict(classes=10, thumbnail=True, layout="NHWC")
SPEC = ([1, 1, 1, 1], [8, 16, 32, 64, 128])


def _step(seed=5):
    net = ResNetV1(BottleneckV1, *SPEC, device="cpu", seed=seed, **NET)
    opt = SGD(learning_rate=0.1, momentum=0.9, wd=1e-4,
              lr_scheduler=FactorScheduler(step=2, factor=0.5))
    return net, TrainStep(net, SoftmaxCrossEntropyLoss(), opt, device="cpu")


def _batch():
    rs = np.random.RandomState(0)
    return rs.rand(4, 16, 16, 3).astype(np.float32), \
        rs.randint(0, 10, 4).astype(np.float32)


def test_restored_step_continues_bit_for_bit(tmp_path):
    x, y = _batch()
    net, step = _step()
    losses = [step(x, y).item() for _ in range(4)]
    want = {k: v.clone() for k, v in net.state_dict().items()}
    want_moms = [s.clone() for s in step._states]

    net2, step2 = _step()
    for _ in range(3):
        step2(x, y)
    ckpt = TrainCheckpoint(tmp_path / "ck")
    ckpt.save(step2, 3, extra={"epoch_of_data": 1})
    after_save = torch.rand(3)
    net3, step3 = _step(seed=11)          # other weights, fresh optimizer
    assert ckpt.restore(step3) == 3
    assert torch.equal(torch.rand(3), after_save)
    assert step3._optimizer.num_update == 3
    assert step3(x, y).item() == losses[3]
    for key, t in net3.state_dict().items():
        assert torch.equal(t, want[key]), key
    for a, b in zip(step3._states, want_moms):
        assert torch.equal(a, b)
    assert ckpt.restore_extra() == {"epoch_of_data": 1}


def test_max_to_keep_async_and_context_manager(tmp_path):
    x, y = _batch()
    _, step = _step()
    step(x, y)
    with TrainCheckpoint(tmp_path / "ck", max_to_keep=2,
                         async_save=True) as ckpt:
        for epoch in range(4):
            ckpt.save(step, epoch)
        ckpt.wait()
        assert ckpt.all_epochs() == [2, 3]
        assert ckpt.valid_epochs() == [2, 3]
        assert ckpt.latest_epoch() == 3
    assert not [n for n in os.listdir(tmp_path / "ck")
                if n.startswith(".tmp")]


@pytest.mark.parametrize("damage", ["truncated_state", "garbage_metadata"])
def test_corrupt_epoch_is_skipped_and_refused(tmp_path, damage):
    x, y = _batch()
    _, step = _step()
    step(x, y)
    ckpt = TrainCheckpoint(tmp_path / "ck")
    ckpt.save(step, 1)
    ckpt.save(step, 2)
    path = tmp_path / "ck" / "2"
    if damage == "truncated_state":
        data = (path / "state.pt").read_bytes()
        (path / "state.pt").write_bytes(data[:len(data) // 3])
    else:
        (path / "metadata.json").write_text("{not json")
    assert ckpt.latest_epoch(validate=False) == 2
    if damage == "garbage_metadata":
        assert ckpt.latest_epoch() == 1
        assert ckpt.valid_epochs() == [1]
        assert ckpt.restore(step) == 1
    else:
        with pytest.raises(MXNetError, match=r"epoch 2 at .*corrupt"):
            ckpt.restore(step, 2)


def test_empty_directory_and_tree_round_trip_like_jax(tmp_path):
    from incubator_mxnet_tpu.parallel import TrainCheckpoint as JaxCkpt
    rs = np.random.RandomState(3)
    tree = {"params": [rs.randn(3, 4).astype(np.float32),
                       rs.randn(5).astype(np.float32)],
            "opt_states": [rs.randn(3, 4).astype(np.float32)]}
    extra = {"lr": 0.05, "epoch": 7}
    j = JaxCkpt(tmp_path / "jax")
    t = TrainCheckpoint(tmp_path / "port")
    for ck in (j, t):
        assert ck.latest_epoch() == -1
        assert ck.restore_tree() is None
        assert ck.restore_extra() is None
    _, step = _step()
    assert t.restore(step) == -1
    j.save_tree(7, tree, extra=extra)
    j.wait()
    t.save_tree(7, {k: [torch.from_numpy(a) for a in v]
                    for k, v in tree.items()}, extra=extra)
    assert t.all_epochs() == j.all_epochs() == [7]
    assert t.restore_extra(7) == j.restore_extra(7) == extra
    got, ref = t.restore_tree(7), j.restore_tree(7)
    for key in tree:
        for g, r in zip(got[key], ref[key]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    j.close()
    t.close()
