"""The port's decode cache (``data/cache.py``: ``DecodedCache``,
``CachedAugment``) on the CPU: the cases of ``tests/test_decode_cache.py``
run against the port (lazy fill and hits, the stale row's gen bump, the
torn read, row reassignment, reopen / subset / growth / truncation, mtime
and base-size invalidation, passthrough, concurrent fill and construction),
the decoded rows bit-equal to the JAX package's cache, and the fill-path
repair: a fill whose row is reassigned, invalidated or refilled by another
handle during its decode writes neither pixels nor flag (the JAX package
writes both), and a reopen waits while a fill writes."""

import multiprocessing as mp
import os
import threading
import time

import numpy as np
import pytest

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.data import cache as jax_cache
from weather_unet_tpu_torch.cli.common import wrap_decode_cache
from weather_unet_tpu_torch.data.cache import CachedAugment, DecodedCache
from weather_unet_tpu_torch.data.datasets import ImagePathDataset
from weather_unet_tpu_torch.data.pipeline import BatchLoader
from weather_unet_tpu_torch.data.transforms import (
    NativeAugment, fork_stream, make_train_augment)


def save(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path, quality=92)
    return str(path)


@pytest.fixture()
def jpegs(tmp_path):
    rng = np.random.default_rng(0)
    return [save(tmp_path / f"{i}.jpg",
                 rng.integers(0, 255, (64, 80, 3), np.uint8))
            for i in range(6)]


def fills_lazily_and_hits(d, jpegs, tmp_path):
    c = DecodedCache(d, base_size=32, paths=jpegs)
    a = c.get(jpegs[0])
    assert a.shape == (32, 32, 3) and a.dtype == np.uint8
    assert (c.hits, c.misses) == (0, 1)
    np.testing.assert_array_equal(c.get(jpegs[0]), a)
    assert (c.hits, c.misses) == (1, 1)
    # the rows are the JAX package's cache's, bit for bit (a PNG through
    # Pillow, JPEGs through the native decode)
    png = save(tmp_path / "x.png", np.full((30, 50, 3), 77, np.uint8))
    c2 = DecodedCache(d + "2", base_size=40, paths=jpegs + [png])
    ref = jax_cache.DecodedCache(d + "_jax", base_size=40,
                                 paths=jpegs + [png])
    for p in jpegs + [png]:
        np.testing.assert_array_equal(c2.get(p), ref.get(p))


def stale_row_bumps_gen(d, jpegs, tmp_path):
    c1 = DecodedCache(d, base_size=32, paths=jpegs)
    c1.populate()
    row = c1._rows[os.path.abspath(jpegs[2])]
    assert int(c1.gen[row]) == 0
    time.sleep(0.01)
    save(jpegs[2], np.zeros((64, 80, 3), np.uint8))
    c2 = DecodedCache(d, base_size=32, paths=jpegs)
    assert c2._rows[os.path.abspath(jpegs[2])] == row
    assert int(c2.present[row]) == 0 and int(c2.gen[row]) == 1
    assert c1.get(jpegs[2]).mean() < 1.0     # never the old cached bytes
    assert int(c2.gen[(row + 1) % len(jpegs)]) == 0


def rejects_torn_read(d, jpegs, tmp_path):
    c = DecodedCache(d, base_size=32, paths=jpegs)
    c.populate()
    row = c._rows[os.path.abspath(jpegs[0])]
    true_img = np.array(c.data[row])

    class InvalidateOnRead:
        """Another process invalidates and refills the row while the copy
        is in flight."""

        def __init__(self, data):
            self._data = data

        def __getitem__(self, i):
            view = self._data[i]
            if i == row:
                c.present[row] = 0
                c.gen[row] += 1
                self._data[i] = 0
                c.present[row] = 1
            return view

        def __setitem__(self, i, v):
            self._data[i] = v

    c.data = InvalidateOnRead(c.data)
    np.testing.assert_array_equal(c.get(jpegs[0]), true_img)


def reassigned_row_never_serves_wrong_image(d, jpegs, tmp_path):
    a, b = jpegs[0], jpegs[1]
    other = save(tmp_path / "c_img.jpg", np.full((64, 80, 3), 30, np.uint8))
    p1 = DecodedCache(d, base_size=32, paths=[a, b])
    p1.populate()
    true_b = p1.get(b)
    row_b = p1._rows[os.path.abspath(b)]
    p2 = DecodedCache(d, base_size=32, paths=[a, other])
    assert p2._rows[os.path.abspath(other)] == row_b
    c_img = p2.get(other)
    assert int(p2.present[row_b]) == 1
    got = p1.get(b)
    np.testing.assert_array_equal(got, true_b)
    assert not np.array_equal(got, c_img)
    assert p1.hits == 1


def reopens_without_gen_file(d, jpegs, tmp_path):
    DecodedCache(d, base_size=32, paths=jpegs).populate()
    os.remove(os.path.join(d, "gen.npy"))
    c2 = DecodedCache(d, base_size=32, paths=jpegs)
    assert c2.get(jpegs[1]).shape == (32, 32, 3)
    assert c2.hits == 1 and int(c2.gen[0]) == 0


def reopen_keeps_rows(d, jpegs, tmp_path):
    c1 = DecodedCache(d, base_size=32, paths=jpegs)
    first = {p: c1.get(p) for p in jpegs}
    for paths in ([jpegs[i] for i in (4, 1, 5, 0, 3, 2)], jpegs[2:5]):
        c2 = DecodedCache(d, base_size=32, paths=paths)
        for p in paths:
            np.testing.assert_array_equal(c2.get(p), first[p])
        assert c2.misses == 0 and c2.hits == len(paths)
    c3 = DecodedCache(d, base_size=32, paths=jpegs)   # after the subset
    c3.populate()
    assert c3.misses == 0


def growth_keeps_decoded_rows(d, jpegs, tmp_path):
    c1 = DecodedCache(d, base_size=32, paths=jpegs[:3])
    first = {p: np.array(c1.get(p)) for p in jpegs[:3]}
    old_mapping = c1.data
    extra = save(tmp_path / "extra.jpg", np.zeros((64, 80, 3), np.uint8))
    c2 = DecodedCache(d, base_size=32, paths=jpegs + [extra])
    c2.populate()
    assert c2.misses == len(jpegs) - 3 + 1
    for p in jpegs[:3]:
        np.testing.assert_array_equal(c2.get(p), first[p])
    # the mapping from before the growth still reads (renamed, not cut)
    assert int(np.asarray(old_mapping[0]).sum()) == int(
        first[jpegs[0]].sum())


def missing_present_file_refills(d, jpegs, tmp_path):
    c1 = DecodedCache(d, base_size=32, paths=jpegs)
    first = {p: c1.get(p) for p in jpegs}
    del c1
    os.remove(os.path.join(d, "present.npy"))
    c2 = DecodedCache(d, base_size=32, paths=jpegs)
    for p in jpegs:
        np.testing.assert_array_equal(c2.get(p), first[p])
    assert c2.misses == len(jpegs)


def truncated_data_refills_tail(d, jpegs, tmp_path):
    c1 = DecodedCache(d, base_size=32, paths=jpegs)
    first = {p: np.array(c1.get(p)) for p in jpegs}
    rows = dict(c1._rows)
    del c1
    path = os.path.join(d, "data.npy")
    full = np.array(np.lib.format.open_memmap(path, mode="r"))
    os.remove(path)
    m = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8,
                                  shape=(3,) + full.shape[1:])
    m[:] = full[:3]
    m.flush()
    del m
    c2 = DecodedCache(d, base_size=32, paths=jpegs)   # grows 3 -> 6 rows
    for p in jpegs:
        np.testing.assert_array_equal(c2.get(p), first[p])
    assert c2.misses == sum(1 for p in jpegs if rows[p] >= 3)
    assert c2.hits == sum(1 for p in jpegs if rows[p] < 3)


def mtime_and_base_size_invalidate(d, jpegs, tmp_path):
    DecodedCache(d, base_size=32, paths=jpegs).populate()
    save(jpegs[2], np.full((64, 80, 3), 200, np.uint8))
    os.utime(jpegs[2], ns=(1, 10 ** 18))
    c2 = DecodedCache(d, base_size=32, paths=jpegs)
    assert c2.get(jpegs[2]).mean() > 150
    assert c2.misses == 1
    c3 = DecodedCache(d, base_size=48, paths=jpegs)
    assert c3.get(jpegs[0]).shape == (48, 48, 3) and c3.misses == 1


def unknown_path_passes_through(d, jpegs, tmp_path):
    c = DecodedCache(d, base_size=32, paths=jpegs[:2])
    assert c.get(jpegs[5]).shape == (32, 32, 3)
    assert c.misses == 0


CASES = [fills_lazily_and_hits, stale_row_bumps_gen, rejects_torn_read,
         reassigned_row_never_serves_wrong_image, reopens_without_gen_file,
         reopen_keeps_rows, growth_keeps_decoded_rows,
         missing_present_file_refills, truncated_data_refills_tail,
         mtime_and_base_size_invalidate, unknown_path_passes_through]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_cache_cases(tmp_path, jpegs, case):
    case(str(tmp_path / "c"), jpegs, tmp_path)


@pytest.mark.parametrize("race", ["reassigned", "invalidated", "refilled"])
def test_fill_rechecks_owner_and_gen_before_the_flag(tmp_path, jpegs, race):
    """Another handle reopens the cache while this one decodes a miss: it
    reassigns the row to a new path, invalidates it because the source
    changed, or reassigns it and fills and flags it for the new path.  The
    fill writes neither pixels nor flag, the caller still gets its own
    image, and the row's next reader gets its own path's image: decoded
    where the row was left unfilled, a hit where the new owner filled
    it."""
    d = str(tmp_path / "c")
    a, b = jpegs[0], jpegs[1]
    other = save(tmp_path / "c_img.jpg", np.full((64, 80, 3), 30, np.uint8))
    p1 = DecodedCache(d, base_size=32, paths=[a, b])
    row = p1._rows[os.path.abspath(b)]
    decode, handles = p1._decode, []

    def racing_decode(path):
        img = decode(path)
        if path == b and not handles:
            if race == "invalidated":
                time.sleep(0.01)
                save(b, np.full((64, 80, 3), 220, np.uint8))
                handles.append(DecodedCache(d, base_size=32, paths=[a, b]))
            else:
                handles.append(DecodedCache(d, base_size=32,
                                            paths=[a, other]))
                assert handles[0]._rows[os.path.abspath(other)] == row
                if race == "refilled":
                    handles[0].get(other)
        return img

    p1._decode = racing_decode
    old_b = decode(b)
    np.testing.assert_array_equal(p1.get(b), old_b)
    p2 = handles[0]
    assert int(p1.present[row]) == (race == "refilled")
    if race == "invalidated":
        assert p2.get(b).mean() > 150          # the new bytes, decoded
        assert (p2.hits, p2.misses) == (0, 1)
    else:
        np.testing.assert_array_equal(p2.get(other), decode(other))
        assert (p2.hits, p2.misses) == (
            (1, 1) if race == "refilled" else (0, 1))


def test_fill_holds_off_a_reopen_from_check_to_flag(tmp_path, jpegs):
    """A reopen that reassigns the row while a fill writes it waits for
    the fill's flag; the row then belongs to the new path, whose reader
    gets its own image, and the old path's reader decodes its source."""
    d = str(tmp_path / "c")
    a, b = jpegs[0], jpegs[1]
    other = save(tmp_path / "c_img.jpg", np.full((64, 80, 3), 30, np.uint8))
    p1 = DecodedCache(d, base_size=32, paths=[a, b])
    row = p1._rows[os.path.abspath(b)]
    handles, data = [], p1.data

    class ReopenOnWrite:
        def __getitem__(self, i):
            return data[i]

        def __setitem__(self, i, v):
            t = threading.Thread(target=lambda: handles.append(
                DecodedCache(d, base_size=32, paths=[a, other])))
            t.start()
            t.join(0.3)
            assert t.is_alive() and not handles   # held off by the fill
            data[i] = v
            handles.append(t)

    p1.data = ReopenOnWrite()
    old_b = p1._decode(b)
    np.testing.assert_array_equal(p1.get(b), old_b)
    handles[0].join(60)
    p2 = handles[1]
    assert p2._rows[os.path.abspath(other)] == row
    assert int(p2.present[row]) == 0
    np.testing.assert_array_equal(p2.get(other), p2._decode(other))
    np.testing.assert_array_equal(p2.get(other), p2._decode(other))
    assert (p2.hits, p2.misses) == (1, 1)
    p1.data = data
    np.testing.assert_array_equal(p1.get(b), old_b)
    assert p1.hits == 0


def test_cache_concurrent_fill_and_construction(tmp_path, jpegs):
    """Loader threads racing on the same rows get the single-thread images
    with no torn row; two processes constructing one cache dir at once (the
    file lock) leave it consistent."""
    import concurrent.futures

    ref = {p: DecodedCache(str(tmp_path / "ref"), base_size=32,
                           paths=jpegs).get(p) for p in jpegs}
    c = DecodedCache(str(tmp_path / "c"), base_size=32, paths=jpegs)
    work = [p for _ in range(8) for p in jpegs]
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(c.get, work))
    for p, img in zip(work, got):
        np.testing.assert_array_equal(img, ref[p])
    assert all(c.present[r] for r in c._rows.values())
    assert c.hits + c.misses == len(work)

    d = str(tmp_path / "mp")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_construct_and_read, args=(d, jpegs, r, q))
             for r in range(2)]
    for p in procs:
        p.start()
    results = dict(q.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=120)
    assert all(p.exitcode == 0 for p in procs)
    assert isinstance(results[0], list) and results[0] == results[1], results
    c2 = DecodedCache(d, base_size=32, paths=jpegs)
    c2.populate()
    assert c2.misses == 0
    assert [int(c2.get(p).sum()) for p in jpegs] == results[0]


def _construct_and_read(d, jpegs, rank, q):
    try:
        c = DecodedCache(d, base_size=32, paths=jpegs)
        q.put((rank, [int(c.get(p).sum()) for p in jpegs]))
    except Exception as e:  # reported to the parent
        q.put((rank, repr(e)))


def test_cached_augment_routes_streams_and_loader(tmp_path, jpegs):
    """Any extension goes through the cache (``from_path_any``) on the keyed
    stream, replayably; a loader's second epoch is all hits with fresh
    augmentations; ``fork_stream`` re-wraps the same cache on seed + 1;
    ``wrap_decode_cache`` builds the wrapper (and passes through without a
    directory)."""
    png = save(tmp_path / "x.png",
               np.random.default_rng(1).integers(0, 255, (64, 80, 3),
                                                 np.uint8))
    paths = jpegs[:2] + [png]
    cache = DecodedCache(str(tmp_path / "c"), base_size=48, paths=paths)
    aug = CachedAugment(cache, NativeAugment(32, seed=5))
    assert aug.from_path_any and aug.route.startswith("decode cache + ")
    img = ImagePathDataset(paths, out_size=48, transform=aug)[2][0]
    assert img.shape == (32, 32, 3) and cache.misses == 1
    ImagePathDataset(paths, out_size=48, transform=aug)[2]
    assert cache.hits == 1
    cache2 = DecodedCache(str(tmp_path / "c"), base_size=48, paths=paths)
    aug2 = CachedAugment(cache2, NativeAugment(32, seed=5))
    np.testing.assert_array_equal(
        ImagePathDataset(paths, out_size=48, transform=aug2)[2][0], img)

    forked = fork_stream(aug)
    assert forked.cache is cache and forked.augment.seed == 6
    assert isinstance(forked, CachedAugment)

    c = DecodedCache(str(tmp_path / "e"), base_size=32, paths=jpegs)
    ds = ImagePathDataset(jpegs, out_size=32, transform=CachedAugment(
        c, make_train_augment(24, resized_crop=True, seed=3)))
    ld = BatchLoader(ds, batch_size=3, shuffle=False, num_workers=2)
    ld.set_epoch(0)
    e1 = [b for b in ld]
    assert c.misses == len(jpegs)
    ld.set_epoch(1)
    e2 = [b for b in ld]
    assert c.misses == len(jpegs) and c.hits == len(jpegs)
    assert e1[0][0].shape == (3, 24, 24, 3)
    assert not np.array_equal(e1[0][0], e2[0][0])

    base = NativeAugment(24)
    assert wrap_decode_cache(base, None, 32, jpegs) is base
    wrapped = wrap_decode_cache(base, str(tmp_path / "w"), 40, jpegs)
    assert isinstance(wrapped, CachedAugment) and wrapped.augment is base
    assert wrapped.cache.base == 40
    assert os.path.exists(os.path.join(str(tmp_path / "w"), "index.json"))
