"""Decoded-image cache: decode each source image once, augment every epoch
-- the port of ``weather_unet_tpu/data/cache.py``.

The reference pipeline re-decodes every JPEG every epoch in DataLoader
workers (``t_est_train.py:176-196``).  Where decode dominates the input
pipeline (a GAN step takes 2 x batch images, content and random streams),
the loader becomes the trainer's bottleneck.  Caching the *decoded,
base-sized* uint8 image in a memory-mapped file removes the decode from
every epoch after the first, while augmentation (the part that must be
random per epoch) still runs per sample.

Layout under ``cache_dir``:

    index.json   {"base_size", "entries": {path: {"row", "mtime", "size"}}}
    data.npy     uint8 memmap (N, base, base, 3)
    present.npy  uint8 flags — row filled markers (crash-safe lazy fill)
    gen.npy      uint32 per-row invalidation counters (torn-read guard)
    owner.npy    uint64 per-row path hashes (row-reassignment guard)

Rows fill lazily on first access (the first epoch pays decode exactly like
the uncached path; later epochs read at page-cache speed).  Stale entries
(mtime/size changed) re-decode in place.  Concurrent loader threads may
race on the same unfilled row — both write identical bytes, so the race is
benign.  The pixel write and the ``present`` flag happen under a SHARED
lock on the cache dir, which construction (the only place that reassigns
or invalidates a row) takes exclusively; inside it the fill first checks
that the row's owner and gen are still the ones seen before the decode,
and writes nothing if either moved (``_fill``).

The identical-bytes argument does NOT cover a row whose source image
CHANGED on disk: a second process re-opening the cache clears ``present``
and lazily re-decodes NEW bytes into the row while a first process may be
mid-read.  ``get`` therefore runs a seqlock-style
protocol: snapshot ``gen[row]``, COPY the pixels, and accept only if
``gen`` and ``present`` are unchanged — the invalidator clears ``present``
and then bumps ``gen`` (fillers never touch ``gen``), so any refill that
could have overlapped the copy is detected and the reader falls back to
decoding the source directly.  ``gen`` alone cannot catch a row REASSIGNED
to a different path by a reopen over a changed corpus (the bump lands
before a late reader's snapshot and the new fill looks stable), so reads
additionally require ``owner.npy``'s per-row path hash to match —
otherwise the reader serves its source file.

Usage (any dataset transform seam)::

    aug = make_train_augment(224, ...)
    cached = CachedAugment(DecodedCache(cache_dir, base_size=257, paths=paths), aug)
    ds = ImagePathDataset(paths, out_size=257, transform=cached)
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional, Sequence

import numpy as np


class DecodedCache:
    """Lazily-filled memmap of decoded base-size images, keyed by path."""

    def __init__(self, cache_dir: str, base_size: int, paths: Sequence[str]):
        self.dir = os.path.expanduser(cache_dir)
        self.base = int(base_size)
        os.makedirs(self.dir, exist_ok=True)
        self._index_path = os.path.join(self.dir, "index.json")
        self._data_path = os.path.join(self.dir, "data.npy")
        self._present_path = os.path.join(self.dir, "present.npy")
        self._gen_path = os.path.join(self.dir, "gen.npy")
        self._owner_path = os.path.join(self.dir, "owner.npy")
        # hits/misses are counted from every loader thread
        self._count_lock = threading.Lock()

        # Several processes (two runs, or the ranks of a multi-process run
        # in the JAX package) may open one cache dir at once.  Construction
        # must be
        # serialized ACROSS PROCESSES: two ranks fresh-creating data.npy
        # concurrently would O_TRUNC a file the other already mmapped
        # (SIGBUS) and zero its present flags.  With the lock, the second
        # rank sees the first's completed files and takes the reuse path.
        # Row fills take the same lock shared (``_fill``), so no row changes
        # owner or gen between a fill's check and its flag.
        import fcntl

        self._lock_path = os.path.join(self.dir, ".lock")
        with open(self._lock_path, "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                self._build(paths)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    def _build(self, paths: Sequence[str]):
        paths = [os.path.abspath(p) for p in dict.fromkeys(paths)]
        old = self._load_index()
        capacity = self._data_capacity()
        old_entries = (old["entries"]
                       if old is not None and capacity > 0
                       and old.get("base_size") == self.base else {})

        # Row assignment is ORDER-INSENSITIVE: a path already in the index
        # keeps its old row, new paths take free rows.  The training CLIs
        # shuffle path order every run, so a positional (row == list index)
        # match would zero the whole cache on every restart/resume.
        rows = self._assign_rows(paths, old_entries, capacity)
        grown = False
        if rows is None and capacity > 0 and old_entries:
            # Corpus outgrew the file (or the index is corrupt): retry the
            # same assignment against a larger capacity.  Success means the
            # old rows are all consistent — GROW the files instead of
            # refilling, preserving every already-decoded row (a user adding
            # images to a dataset shouldn't pay a full re-decode).
            new_cap = max(len(paths), capacity)
            rows = self._assign_rows(paths, old_entries, new_cap)
            if rows is not None and new_cap > capacity:
                grown, capacity = True, new_cap
        reuse = rows is not None and not grown
        if rows is None:                # no reusable file / corrupt index
            capacity, rows = len(paths), {p: i for i, p in enumerate(paths)}
            old_entries = {}
        self._rows = rows

        entries, stale_rows = {}, []
        for p in paths:
            st = self._stat(p)
            prev = old_entries.get(p)
            fresh = (prev is not None and prev["row"] == rows[p]
                     and prev["mtime"] == st[0] and prev["size"] == st[1])
            if not fresh:
                stale_rows.append(rows[p])
            entries[p] = {"row": rows[p], "mtime": st[0], "size": st[1]}

        # Carry forward old entries whose rows weren't reassigned, so a run
        # over a SUBSET of the corpus (e.g. a debug slice) doesn't evict the
        # rest of the cache.  Carried paths aren't served this run (not in
        # self._rows) — a future reopen that includes them re-stats and
        # reuses their rows.
        assigned = set(rows.values())
        for p, e in old_entries.items():
            r = e.get("row")
            if (p not in entries and isinstance(r, int) and 0 <= r < capacity
                    and r not in assigned):
                entries[p] = {"row": r, "mtime": e["mtime"], "size": e["size"]}
                assigned.add(r)

        # _data_capacity already verified dtype/base dims, so reuse implies
        # the existing file's shape is exactly (capacity, base, base, 3).
        shape = (capacity, self.base, self.base, 3)
        if reuse:
            self.data = np.lib.format.open_memmap(
                self._data_path, mode="r+", dtype=np.uint8, shape=shape)
            self.present = self._open_present(capacity, fresh_ok=True)
        elif grown:
            self.data, self.present = self._grow_pair(shape)
        else:
            self.data = self._fresh_memmap(self._data_path, shape)
            self.present = self._open_present(capacity, fresh_ok=False)
        self.gen = self._open_gen(capacity, keep=reuse)
        self.owner = self._open_owner(capacity, keep=reuse)
        # Row OWNERSHIP (64-bit path hash per row): gen alone cannot tell a
        # same-path refill (serveable) from a row REASSIGNED to a different
        # path by a later reopen over a changed corpus — a live reader of
        # the dropped path would pass the gen recheck and serve the new
        # path's pixels as a hit.
        # Write ownership BEFORE the invalidation loop: from that store on,
        # the dropped path's readers fail their owner check and decode from
        # source; before it, the row still holds the old path's bytes.
        self._owner_hash = {p: self._hash64(p) for p in rows}
        for p, e in entries.items():
            self.owner[e["row"]] = self._owner_hash.get(p) or self._hash64(p)
        for r in stale_rows:            # invalidate stale/new rows
            # order is load-bearing for get()'s seqlock: clear the flag
            # FIRST, bump gen second.  A reader that saw the old flag=1 and
            # copies concurrently with the later refill must observe a gen
            # change at its recheck (the refill can only start after this
            # bump); a reader that snapshots gen after the bump either sees
            # flag=0 (decodes fresh) or flag=1 re-set by a COMPLETED refill
            # (stable new bytes).
            self.present[r] = 0
            if reuse:
                # only a REUSED (shared-inode) file can have live readers
                # in other processes; fresh/grown builds just replaced the
                # inodes, so old readers never see these rows
                self.gen[r] += 1
        with open(self._index_path + ".tmp", "w") as f:
            json.dump({"base_size": self.base, "entries": entries}, f)
        os.replace(self._index_path + ".tmp", self._index_path)
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _fresh_memmap(path: str, shape, dtype=np.uint8) -> np.memmap:
        """Create a fresh memmap at ``path`` WITHOUT truncating the
        existing inode: ``open_memmap(mode='w+')`` O_TRUNCs in place, which
        would SIGBUS (or silently re-point rows for) a live process that
        still has the old file mapped — e.g. a training run mid-epoch while
        a second run rebuilds the cache for a grown corpus.  Writing to a
        temp name and ``os.replace``-ing keeps the old inode alive for its
        mappers; the mapping returned here stays valid across the rename
        (same inode)."""
        tmp = path + ".tmp"
        m = np.lib.format.open_memmap(tmp, mode="w+", dtype=dtype,
                                      shape=shape)
        os.replace(tmp, path)
        return m

    def _grow_pair(self, shape):
        """Replace data+present with larger memmaps, copying the old rows in
        as a prefix (row indices are preserved by ``_assign_rows``, so a
        straight block copy keeps every filled row valid).  New rows are
        zero (fresh memmap pages), i.e. not-present.  Same no-truncate
        rename discipline as :meth:`_fresh_memmap`.

        Ordering is load-bearing against the documented lock-free lazy
        fills of a concurrent OLD-cache process (pixels first, flag after):
        the FLAGS snapshot is taken BEFORE the pixel copy, so flag=1 in the
        snapshot implies the pixels landed before the copy read them; a row
        filled in between just reads as absent and re-decodes.  Copying
        data-then-present would invert that and could mark never-copied
        rows present.  If the old data file cannot be read at all, the
        flags are dropped (all rows refill lazily) rather than pointing at
        zero pixels."""
        flags = None
        try:
            old_p = np.lib.format.open_memmap(self._present_path, mode="r")
            if old_p.dtype == np.uint8 and old_p.ndim == 1:
                flags = np.array(old_p)             # snapshot, then pixels
        except Exception:
            pass
        try:                # open the old mapping BEFORE the rename drops it
            old_d = np.lib.format.open_memmap(self._data_path, mode="r")
        except Exception:
            old_d = None
        data = self._fresh_memmap(self._data_path, shape)
        if old_d is not None and old_d.shape[1:] == shape[1:]:
            n = min(old_d.shape[0], shape[0])
            data[:n] = old_d[:n]
        else:
            flags = None                            # no pixels → no flags
        present = self._fresh_memmap(self._present_path, (shape[0],))
        if flags is not None:
            # Clamp to the OLD DATA's row count too: an inconsistent pair
            # (present.npy longer than data.npy, e.g. from a partial copy of
            # a cache dir) must not mark rows present beyond the copied
            # pixel prefix — those rows would serve all-zero images for any
            # mtime-fresh path assigned to them.
            n = min(flags.shape[0], old_d.shape[0], shape[0])
            present[:n] = flags[:n]
        return data, present

    @staticmethod
    def _assign_rows(paths, old_entries, capacity):
        """Map each path to a data row, reusing the old index's assignments.

        Returns ``None`` when the existing file cannot host the new corpus
        (no file, duplicate/out-of-range rows in a corrupt index, or more
        new paths than free rows) — the caller then rebuilds from scratch.
        """
        if capacity <= 0:
            return None
        kept = {p: old_entries[p]["row"] for p in paths
                if p in old_entries and 0 <= old_entries[p]["row"] < capacity}
        used = set(kept.values())
        if len(used) != len(kept):      # corrupt index: duplicate rows
            return None
        # New paths take rows no old entry references first, then rows of
        # entries dropped from the corpus (preserves as much cache as
        # possible across subset/superset reopens).
        referenced = {e["row"] for e in old_entries.values()}
        free = iter(sorted(set(range(capacity)) - used,
                           key=lambda r: (r in referenced, r)))
        rows = dict(kept)
        try:
            for p in paths:
                if p not in rows:
                    rows[p] = next(free)
        except StopIteration:
            return None                 # corpus grew past file capacity
        return rows

    def _open_present(self, n: int, fresh_ok: bool):
        """Open (or rebuild) the row-filled flag vector.

        A missing/truncated ``present.npy`` next to a valid data file (e.g.
        a partial copy of a cache dir) must rebuild the flags — refilling
        lazily — not crash the constructor."""
        if fresh_ok:
            try:
                m = np.lib.format.open_memmap(self._present_path, mode="r+")
                if m.shape == (n,) and m.dtype == np.uint8:
                    return m
            except Exception:
                pass
        m = self._fresh_memmap(self._present_path, (n,))
        m[:] = 0
        return m

    def _open_gen(self, n: int, keep: bool):
        """Open (or create) the per-row invalidation counters.

        ``keep=True`` (the reuse path) re-opens the shared file so
        concurrent processes on the same inode see each other's bumps;
        otherwise fresh zeros — correct because a fresh/grown build also
        replaced data+present via rename, so older processes read the OLD
        inodes, which the new process never writes (no shared rows to
        tear).  A stale/garbage gen value can only cause a spurious reader
        fallback to source decode, never a false accept."""
        if keep:
            try:
                m = np.lib.format.open_memmap(self._gen_path, mode="r+")
                if m.shape == (n,) and m.dtype == np.uint32:
                    return m
            except Exception:
                pass
        m = self._fresh_memmap(self._gen_path, (n,), dtype=np.uint32)
        m[:] = 0
        return m

    def _open_owner(self, n: int, keep: bool):
        """Open (or create) the per-row path-ownership hashes (uint64
        blake2b of the abspath).  Same keep-vs-fresh rationale as
        :meth:`_open_gen`; a zero/garbage value only causes a spurious
        fallback to source decode, never a wrong-image hit."""
        if keep:
            try:
                m = np.lib.format.open_memmap(self._owner_path, mode="r+")
                if m.shape == (n,) and m.dtype == np.uint64:
                    return m
            except Exception:
                pass
        m = self._fresh_memmap(self._owner_path, (n,), dtype=np.uint64)
        m[:] = 0
        return m

    @staticmethod
    def _hash64(path: str) -> np.uint64:
        import hashlib

        return np.uint64(int.from_bytes(
            hashlib.blake2b(path.encode("utf-8", "replace"),
                            digest_size=8).digest(), "little"))

    def _stat(self, p):
        try:
            st = os.stat(p)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return (0, -1)

    def _load_index(self) -> Optional[dict]:
        try:
            with open(self._index_path) as f:
                return json.load(f)
        except Exception:
            return None

    def _data_capacity(self) -> int:
        """Rows in the existing data file, 0 if absent/incompatible."""
        try:
            m = np.lib.format.open_memmap(self._data_path, mode="r")
            if m.dtype == np.uint8 and m.shape[1:] == (self.base, self.base, 3):
                return m.shape[0]
        except Exception:
            pass
        return 0

    def _decode(self, path: str) -> np.ndarray:
        from weather_unet_tpu_torch.data.datasets import _decode

        # single decode-with-fallback definition (datasets._decode);
        # prefer_native=True because the cache fill is the decode-heavy
        # stage and feeds training only (no PIL-parity requirement)
        return _decode(path, self.base, prefer_native=True)

    def get(self, path: str) -> np.ndarray:
        """Decoded base-size uint8 HWC image; decodes and fills on miss.

        Hit path is a seqlock read (module docstring): owner+gen snapshot
        -> pixel COPY -> owner+gen+flag recheck.  A gen/flag change means
        another process invalidated this row (source file changed) while we
        read; an OWNER mismatch means a later reopen reassigned the row to
        a different path entirely (changed corpus) — both fall back to
        decoding the source, which is definitionally fresh.  The copy costs
        ~8 us/row (measured, 257^2x3) vs the ~800 us/img host supply bound
        — noise."""
        ap = os.path.abspath(path)
        row = self._rows.get(ap)
        if row is None:
            return self._decode(path)   # not in the cached set: passthrough
        oh = self._owner_hash.get(ap)
        if oh is None:
            oh = self._owner_hash[ap] = self._hash64(ap)
        g0 = int(self.gen[row])
        if self.owner[row] == oh and self.present[row]:
            buf = np.array(self.data[row])          # copy, then validate
            if (self.gen[row] == g0 and self.present[row]
                    and self.owner[row] == oh):
                with self._count_lock:
                    self.hits += 1
                return buf
            return self._decode(path)   # torn window: serve the source
        if self.owner[row] != oh:
            # row taken by another path — never refill over it (the new
            # owner's filler would race us); serve the source directly
            return self._decode(path)
        img = self._decode(path)
        self._fill(row, oh, g0, img)
        with self._count_lock:
            self.misses += 1
        return img

    def _fill(self, row: int, oh: np.uint64, g0: int, img: np.ndarray):
        """Write a decoded row and flag it, if the row still belongs to the
        path (owner hash ``oh``) at the gen seen before the decode.

        A reopen in another handle may reassign the row to another path, or
        invalidate it, while this fill decodes; that handle may even refill
        and flag the row before this one writes.  The shared lock keeps
        construction (exclusive) out from the check to the flag, so a fill
        either sees the row unchanged and completes, or writes nothing: it
        never lays its pixels over a new owner's, nor flags a row that
        changed hands."""
        import fcntl

        with open(self._lock_path, "a") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_SH)
            if self.owner[row] == oh and int(self.gen[row]) == g0:
                self.data[row] = img
                self.present[row] = 1   # flag AFTER pixels (crash safety)

    def populate(self):
        """Eagerly fill every missing row (one-time warm, optional)."""
        for p, row in self._rows.items():
            if not self.present[row]:
                self.get(p)


class CachedAugment:
    """Transform adapter: decoded-cache lookup + per-sample augmentation.

    Exposes the same surface the datasets' ``_load`` seam dispatches on —
    ``from_path`` (replaces the fused decode+augment call with cache read +
    augment) and ``__call__`` (augment an already-decoded image)."""

    def __init__(self, cache: DecodedCache, augment=None):
        self.cache = cache
        self.augment = augment
        self.route = "decode cache + " + getattr(augment, "route", "none")

    #: the datasets' ``_load`` seam may route ANY extension through
    #: ``from_path`` (the cache decodes via PIL, not just libjpeg) — without
    #: this, non-JPEG corpus images bypassed the cache entirely AND fell
    #: back to the schedule-dependent counter RNG
    from_path_any = True

    def from_path(self, path: str) -> np.ndarray:
        img = self.cache.get(path)
        if self.augment is None:
            return img
        # keyed per-path RNG stream when offered (transforms._KeyedRngMixin)
        keyed = getattr(self.augment, "augment_keyed", None)
        return keyed(img, path) if keyed is not None else self.augment(img)

    def augment_keyed(self, image_u8: np.ndarray, path: str) -> np.ndarray:
        """Keyed-stream augmentation of an already-decoded image, delegated
        to the inner augment (counter-stream fallback when it has none)."""
        if self.augment is None:
            return image_u8
        keyed = getattr(self.augment, "augment_keyed", None)
        return (keyed(image_u8, path) if keyed is not None
                else self.augment(image_u8))

    def set_epoch(self, epoch: int) -> None:
        se = getattr(self.augment, "set_epoch", None)
        if se is not None:
            se(epoch)

    def __call__(self, image_u8: np.ndarray) -> np.ndarray:
        return (self.augment(image_u8) if self.augment is not None
                else image_u8)
