"""The port's PrefetchLoader: the cases of tests/test_loader.py, and batch
for batch the JAX package's loader over the same dataset and seed."""

import time

import numpy as np
import pytest

from cotr_tpu.data.loader import PrefetchLoader as JaxLoader
from cotr_tpu_torch.data.dataset import batch_iterator
from cotr_tpu_torch.data.loader import PrefetchLoader


class ToyDataset:
    def __init__(self, n=10):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((4,), float(i), np.float32)}


class CountingDataset(ToyDataset):
    def __init__(self, n=10):
        super().__init__(n)
        self.calls = 0

    def __getitem__(self, i):
        self.calls += 1
        return super().__getitem__(i)


class SlowFirst(ToyDataset):
    def __getitem__(self, i):
        if i == 0:
            time.sleep(0.2)
        return super().__getitem__(i)


class FailingDataset(ToyDataset):
    def __getitem__(self, i):
        if i == 7:
            raise RuntimeError("synthesis failed")
        return super().__getitem__(i)


def test_prefetch_loader_yields_all_batches():
    loader = PrefetchLoader(ToyDataset(10), batch_size=2, num_workers=3,
                            shuffle=False)
    batches = list(loader)
    assert len(batches) == len(loader) == 5
    seen = sorted(int(b["x"][j, 0]) for b in batches for j in range(2))
    assert seen == list(range(10))
    assert batches[0]["x"].shape == (2, 4)


def test_prefetch_loader_shuffles_per_epoch():
    loader = PrefetchLoader(ToyDataset(10), batch_size=2, shuffle=True, seed=1)
    e1 = [int(b["x"][j, 0]) for b in loader for j in range(2)]
    e2 = [int(b["x"][j, 0]) for b in loader() for j in range(2)]
    assert sorted(e1) == sorted(e2) == list(range(10))
    assert e1 != e2


def test_prefetch_loader_bounds_inflight_work():
    """A stalled consumer stalls the producers: at most num_workers +
    2 * prefetch + 1 batches are ever synthesized while it holds one."""
    ds = CountingDataset(n=400)
    bs, workers, prefetch = 2, 2, 2
    loader = PrefetchLoader(ds, batch_size=bs, num_workers=workers,
                            prefetch=prefetch, shuffle=False)
    it = iter(loader)
    next(it)
    time.sleep(1.0)
    bound = (workers + 2 * prefetch + 1) * bs
    assert ds.calls <= bound, f"synthesized {ds.calls} samples > bound {bound}"
    it.close()


def test_prefetch_loader_order_deterministic_with_slow_items():
    loader = PrefetchLoader(SlowFirst(8), batch_size=2, num_workers=4,
                            shuffle=False)
    assert [int(b["x"][0, 0]) for b in loader] == [0, 2, 4, 6]


def test_prefetch_loader_process_executor():
    loader = PrefetchLoader(ToyDataset(8), batch_size=2, num_workers=2,
                            shuffle=False, executor="process")
    batches = list(loader)
    seen = sorted(int(b["x"][j, 0]) for b in batches for j in range(2))
    assert seen == list(range(8))


def test_prefetch_loader_propagates_errors():
    loader = PrefetchLoader(FailingDataset(10), batch_size=2, shuffle=False)
    with pytest.raises(RuntimeError, match="synthesis failed"):
        list(loader)


def test_prefetch_loader_rejects_an_unknown_executor():
    with pytest.raises(ValueError):
        PrefetchLoader(ToyDataset(4), batch_size=2, executor="fiber")


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batches_equal_the_jax_loader(shuffle, drop_last):
    """Two epochs, batch for batch, over a dataset whose samples depend on
    the index: the same order, the same keys, the same arrays."""
    class Indexed(ToyDataset):
        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            return {"a": rng.rand(3, 2).astype(np.float32),
                    "b": np.full((2,), i, np.int64)}

    kw = dict(batch_size=3, num_workers=3, shuffle=shuffle, seed=4,
              drop_last=drop_last)
    port, ref = PrefetchLoader(Indexed(11), **kw), JaxLoader(Indexed(11), **kw)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_batch_iterator_matches_jax():
    from cotr_tpu.data.dataset import batch_iterator as jax_batch_iterator

    for kw in (dict(shuffle=True, seed=2), dict(shuffle=False,
                                                drop_last=False)):
        got = list(batch_iterator(ToyDataset(7), 3, **kw))
        want = list(jax_batch_iterator(ToyDataset(7), 3, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["x"], w["x"])


def test_synthetic_batches_equal_the_jax_loader(tmp_path):
    """The two packages' loaders over their synthetic datasets (the train
    twin's layout) from the same textures and seed."""
    import PIL.Image

    from cotr_tpu.data.synthetic import SyntheticHomographyDataset as JaxDs
    from cotr_tpu_torch.data.synthetic import SyntheticHomographyDataset

    rng = np.random.RandomState(2)
    png, npy = tmp_path / "t.png", tmp_path / "t.npy"
    tex = rng.randint(0, 256, (320, 300, 3)).astype(np.uint8)
    PIL.Image.fromarray(tex).save(png)
    np.save(npy, tex)
    kw = dict(length=12, num_kp=20, seed=1, device_warp=True, tex_aug=True)
    port = PrefetchLoader(SyntheticHomographyDataset([str(npy)], **kw), 4,
                          num_workers=3, seed=1)
    ref = JaxLoader(JaxDs([str(png)], **kw), 4, num_workers=3, seed=1)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
