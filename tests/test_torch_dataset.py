"""The port's dataset and batch loader against the JAX package's on a
generated VCTK-DEMAND-shaped directory: the same seed gives the same
batches, bit for bit."""

import os

import numpy as np
import pytest

from cmgan_tpu.data import dataset as jds
from cmgan_torch.data import dataset as tds
from cmgan_torch.data import write_wav


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demand")
    rng = np.random.default_rng(0)
    for split, count in (("train", 7), ("test", 3)):
        for kind in ("clean", "noisy"):
            os.makedirs(root / split / kind)
        for i in range(count):
            n = int(rng.integers(2000, 9000))  # some shorter, some longer than cut_len
            clean = (0.1 * rng.standard_normal(n)).astype(np.float32)
            noisy = clean + (0.03 * rng.standard_normal(n)).astype(np.float32)
            # p2 sorts before p10 only in natural order
            write_wav(str(root / split / "clean" / f"p{i * 5}.wav"), clean, 16000)
            write_wav(str(root / split / "noisy" / f"p{i * 5}.wav"), noisy, 16000)
    return str(root)


def test_dataset_items_match(data_dir):
    a = jds.DemandDataset(os.path.join(data_dir, "train"), 4000)
    b = tds.DemandDataset(os.path.join(data_dir, "train"), 4000)
    assert a.names == b.names and len(b) == 7
    for i in range(len(b)):
        ca, na, la = a.__getitem__(i, rng=np.random.default_rng(i))
        cb, nb, lb = b.__getitem__(i, rng=np.random.default_rng(i))
        assert la == lb and cb.shape == (4000,) and cb.dtype == np.float32
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(na, nb)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loaders_give_the_same_batches(data_dir, prefetch):
    ja, _ = jds.load_data(data_dir, 2, 4000, seed=3)
    ta, tt = tds.load_data(data_dir, 2, 4000, seed=3)
    ja.prefetch = ta.prefetch = prefetch
    assert len(ja) == len(ta) == 3 and len(tt) == 2
    for _ in range(2):  # two epochs: the shuffle and the crops move with the epoch
        got = list(ta)
        want = list(ja)
        assert len(got) == 3
        for (c1, n1), (c2, n2) in zip(got, want):
            assert c1.shape == (2, 4000)
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(n1, n2)


def test_test_loader_keeps_the_partial_batch_in_order(data_dir):
    _, jt = jds.load_data(data_dir, 2, 4000, seed=0)
    _, tt = tds.load_data(data_dir, 2, 4000, seed=0)
    got, want = list(tt), list(jt)
    assert [c.shape[0] for c, _ in got] == [2, 1]
    for (c1, n1), (c2, n2) in zip(got, want):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(n1, n2)


def test_process_sharding_matches(data_dir):
    ds = tds.DemandDataset(os.path.join(data_dir, "train"), 4000)
    jd = jds.DemandDataset(os.path.join(data_dir, "train"), 4000)
    for rank in range(2):
        a = tds.BatchLoader(ds, 2, seed=1, num_processes=2, process_index=rank, prefetch=0)
        b = jds.BatchLoader(jd, 2, seed=1, num_processes=2, process_index=rank, prefetch=0)
        np.testing.assert_array_equal(a._epoch_indices(), b._epoch_indices())
        assert len(a) == len(b) == 2
    assert tds.BatchLoader(ds, 2).num_processes == 1


def test_load_data_shards_the_train_loader_only(data_dir):
    """load_data's process shard reaches the train loader, whose batches are
    the JAX loader's at that process; the test loader stays whole, in
    batches of the global batch (batch_size rows a process)."""
    train, test = tds.load_data(data_dir, 2, 4000, seed=3, num_processes=2, process_index=1)
    assert (train.num_processes, train.process_index, train.batch_size) == (2, 1, 2)
    assert (test.num_processes, test.batch_size) == (1, 4)
    want = jds.BatchLoader(jds.DemandDataset(os.path.join(data_dir, "train"), 4000), 2, seed=3,
                           num_processes=2, process_index=1, prefetch=0)
    assert len(train) == len(want) == 2   # ceil(7 / 2) // 2
    for (c1, n1), (c2, n2) in zip(list(train), list(want)):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(n1, n2)
    _, whole = tds.load_data(data_dir, 4, 4000, seed=3)
    got, ref = list(test), list(whole)
    assert [c.shape[0] for c, _ in got] == [c.shape[0] for c, _ in ref] == [3]
    for (c1, _), (c2, _) in zip(got, ref):
        np.testing.assert_array_equal(c1, c2)
