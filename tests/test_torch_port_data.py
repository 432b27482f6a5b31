"""The port's data plane against the JAX package's: the same bytes and the
same indices, bitwise."""

import numpy as np
import pytest

from pytorch_ddp_mnist_tpu.data import idx as jax_idx
from pytorch_ddp_mnist_tpu.data import loader as jax_loader
from pytorch_ddp_mnist_tpu.data import mnist as jax_mnist
from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JaxSampler
from pytorch_ddp_mnist_tpu_torch.data import idx, loader, mnist
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler


@pytest.mark.parametrize("n,seed", [(1, 0), (500, 0), (257, 1), (64, 3)])
def test_synthetic_mnist_is_byte_equal(n, seed):
    a, b = mnist.synthetic_mnist(n, seed), jax_mnist.synthetic_mnist(n, seed)
    assert a.images.dtype == np.uint8 and a.images.shape == (n, 28, 28)
    assert a.images.tobytes() == b.images.tobytes()
    assert a.labels.tobytes() == b.labels.tobytes()


def test_normalize_images_is_byte_equal_and_keeps_the_input():
    images = mnist.synthetic_mnist(300, 2).images
    before = images.copy()
    got = mnist.normalize_images(images)
    assert got.dtype == np.float32 and got.shape == (300, 784)
    assert got.tobytes() == jax_mnist.normalize_images(images).tobytes()
    assert np.array_equal(images, before)
    assert (mnist.MNIST_MEAN, mnist.MNIST_STD) == (jax_mnist.MNIST_MEAN,
                                                   jax_mnist.MNIST_STD)


def test_idx_files_load_the_same(tmp_path):
    split = jax_mnist.synthetic_mnist(40, 5)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    jax_idx.write_idx(str(raw / "t10k-images-idx3-ubyte"), split.images)
    jax_idx.write_idx(str(raw / "t10k-labels-idx1-ubyte"), split.labels)
    got = mnist.load_mnist(str(tmp_path), train=False)
    ref = jax_mnist.load_mnist(str(tmp_path), train=False)
    assert np.array_equal(got.images, ref.images)
    assert np.array_equal(got.labels, ref.labels)
    assert mnist.load_mnist(str(tmp_path), train=True) is None
    assert np.array_equal(idx.read_idx(str(raw / "t10k-labels-idx1-ubyte")),
                          split.labels)


def test_get_mnist_falls_back_to_synthetic(tmp_path):
    got = mnist.get_mnist(str(tmp_path), train=False, synthetic_n=30,
                          quiet=True)
    ref = jax_mnist.get_mnist(str(tmp_path), train=False, synthetic_n=30,
                              quiet=True)
    assert got.images.tobytes() == ref.images.tobytes()
    assert got.labels.tobytes() == ref.labels.tobytes()


@pytest.mark.parametrize("n", [1000, 101, 2])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_sampler_indices_are_bitwise_jax(n, world):
    for rank in range(world):
        ours = ShardedSampler(n, num_replicas=world, rank=rank, seed=42)
        ref = JaxSampler(n, num_replicas=world, rank=rank, seed=42)
        assert len(ours) == len(ref)
        for epoch in range(4):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            a, b = ours.indices(), ref.indices()
            assert a.dtype == b.dtype and np.array_equal(a, b)
            assert np.array_equal(ours.global_permutation(),
                                  ref.global_permutation())


def test_sampler_without_shuffle_and_torch_permutation():
    a = ShardedSampler(10, num_replicas=3, rank=1, shuffle=False)
    b = JaxSampler(10, num_replicas=3, rank=1, shuffle=False)
    assert np.array_equal(a.indices(), b.indices())
    assert list(a) == list(b)
    # the torch permutation source: DistributedSampler's own randperm
    for world, rank in ((1, 0), (3, 2)):
        a = ShardedSampler(10, num_replicas=world, rank=rank,
                           permutation="torch")
        b = JaxSampler(10, num_replicas=world, rank=rank, permutation="torch")
        a.set_epoch(3)
        b.set_epoch(3)
        assert np.array_equal(a.indices(), b.indices())
    with pytest.raises(ValueError, match="permutation must be"):
        ShardedSampler(10, permutation="mt")
    with pytest.raises(ValueError, match="out of range"):
        ShardedSampler(10, num_replicas=2, rank=2)


@pytest.mark.parametrize("n,world,batch", [(1000, 1, 128), (1000, 3, 64),
                                           (50, 2, 7), (5, 1, 8)])
def test_batched_indices_and_loader_are_bitwise_jax(n, world, batch):
    split = mnist.synthetic_mnist(n, 0)
    x = mnist.normalize_images(split.images)
    for rank in range(world):
        for epoch in (0, 3):
            ours = ShardedSampler(n, num_replicas=world, rank=rank)
            ref = JaxSampler(n, num_replicas=world, rank=rank)
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            a = list(loader._batched_indices(ours, batch))
            b = list(jax_loader._batched_indices(ref, batch))
            assert len(a) == len(b)
            assert all(np.array_equal(u, v) for u, v in zip(a, b))
            la = loader.BatchLoader(x, split.labels, ours, batch)
            lb = jax_loader.BatchLoader(x, split.labels, ref, batch)
            assert len(la) == len(lb)
            for (xa, ya), (xb, yb) in zip(la, lb):
                assert xa.shape == (batch, 784) and ya.dtype == np.int32
                assert xa.tobytes() == xb.tobytes()
                assert ya.tobytes() == yb.tobytes()
