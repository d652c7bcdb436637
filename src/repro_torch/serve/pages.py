"""Page-pool management for the paged serving engine.

Host-side twin of :class:`repro_torch.core.qcache.PagedQuantKVCache`: the
card holds the pools and page tables, this module decides which pool page
holds which request's block.  The allocator is the JAX package's
(``repro/serve/pages.py``), decision for decision: the same free-list order,
refcounts, reservations, retained tier and page-affine shards, so one
scripted sequence drives both to the same state.

Commitment accounting: every page the pool has promised is counted once,
either as a **reservation** (``reserved``: pages a live request may still
allocate) or as an **allocated page** (``n_used``, refcounted).
:meth:`PagePool.reserve` admits a request only when
``n_used + reserved + n <= capacity``, and :meth:`PagePool.alloc` moves one
unit from ``reserved`` to ``n_used``, so an alloc a reservation promised
always finds a free page.  A shared page (refcount > 1, :meth:`PagePool.retain`)
sits in ``n_used`` once, however many requests hold it.

**Retained tier**: a prefix-registered page whose last holder departs moves,
when the ``retainable`` predicate accepts it, to an LRU of refcount-0 pages
that stay off the free list with their prefix-index entry live.
:meth:`PagePool.reserve` and :meth:`PagePool.alloc` reclaim from its oldest
end only when the free list cannot cover the request, firing ``on_release``
before the page is reused.

**Ledgers**: each page records its holders (the owner tags of
:meth:`PagePool.alloc` / :meth:`PagePool.retain`; the engine passes request
uids) and each owner its outstanding reservation units, so a free by a
non-holder, a double free or a double release raises at the faulting call.

**Page-affine sharding** (``shards > 1``): the free list splits into
``shards`` contiguous page ranges, matching pools whose page axis is split
across a mesh axis (``dist.splitkv`` with ``page_affine=True``: each rank
holds one range).  ``alloc(shard=c)`` hands out pages of range ``c`` only,
the shard that walks the table columns the page backs; unpinned allocs go
round-robin across the shards with free pages.  Scratch pages sit in shard
0.  Retained-tier reclaim honours the same shard filter.

Scratch pages ``[0, n_scratch)``, one per decode slot, are never allocated:
page tables point unassigned entries at the slot's scratch page, so a flush
through an idle entry lands in private scratch and the destinations of one
flush stay pairwise distinct.

The device side (:func:`adopt_prefill`, :func:`cow_pages`,
:func:`set_page_tables`) writes the engine's stacked pools and tables in
place with torch indexing.
"""
from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.core import qcache as _qc
from repro_torch.core.device import upload


class PagePool:
    """Free-list page allocator with commitment accounting, refcounts, holder
    and owner ledgers, an LRU retained tier and optional page-affine
    shards."""

    def __init__(self, n_pages: int, *, n_scratch: int, page_bytes: int = 0,
                 metrics=None, shards: int = 1):
        """``page_bytes`` is the size of one page across every paged layer
        (the engine measures it from the pools), for occupancy in bytes.
        ``metrics`` (a ``telemetry.MetricsRegistry``) keeps the pool gauges
        current after every accounting change.  ``shards`` splits the free
        list into that many contiguous page ranges (module docstring); the
        scratch pages must fit inside shard 0."""
        if n_pages <= n_scratch:
            raise ValueError(f"n_pages={n_pages} must exceed n_scratch={n_scratch}")
        if shards < 1 or n_pages % shards:
            raise ValueError(f"n_pages={n_pages} must be a positive multiple of "
                             f"shards={shards}")
        if shards > 1 and n_scratch >= n_pages // shards:
            raise ValueError(f"n_scratch={n_scratch} must fit inside shard 0 "
                             f"({n_pages // shards} pages/shard)")
        self.n_pages = n_pages
        self.n_scratch = n_scratch
        self.page_bytes = page_bytes
        self.shards = shards
        pps = n_pages // shards
        self._pages_per_shard = pps
        self._shard_free: list[deque[int]] = [
            deque(range(max(n_scratch, c * pps), (c + 1) * pps)) for c in range(shards)]
        self._free = self._shard_free[0]  # the whole free list when shards == 1
        self._rr = 0  # round-robin shard cursor of unpinned allocs
        self._refcount = np.zeros(n_pages, np.int32)
        self.reserved = 0  # pages promised but not yet allocated
        # RETAINED tier: page -> None, oldest first (LRU eviction order)
        self._retained: dict[int, None] = {}
        self.reclaim_count = 0
        # page -> owner tags (one per reference, in acquisition order)
        self._holders: dict[int, list] = {}
        # owner -> reservation units outstanding (tagged reservations only)
        self._owner_reserved: dict = {}
        # fired with the page id when a page's last reference drops and it
        # returns to the free list (for a retained page: at reclaim time)
        self.on_release: Callable[[int], None] | None = None
        # a page whose last reference drops is retained iff this says so
        self.retainable: Callable[[int], bool] | None = None
        self.metrics = metrics
        self._gauges = None
        self._gauge_last: list[float | None] = [None] * 5
        if metrics is not None:
            self._gauges = tuple(metrics.gauge(n) for n in (
                "pool_pages_used", "pool_pages_reserved", "pool_pages_committed",
                "pool_occupancy", "pool_pages_retained"))
        self._update_gauges()

    def _update_gauges(self) -> None:
        """Write the gauges whose value changed (their high-water marks
        record peak commitment between samples)."""
        if self.metrics is None:
            return
        vals = (float(self.n_used), float(self.reserved), float(self.committed),
                self.occupancy, float(self.n_retained))
        for i, (g, v) in enumerate(zip(self._gauges, vals)):
            if self._gauge_last[i] != v:
                g.set(v)
                self._gauge_last[i] = v

    # ------------------------------------------------------------ capacity

    @property
    def capacity(self) -> int:
        """Allocatable pages (scratch excluded)."""
        return self.n_pages - self.n_scratch

    @property
    def n_free(self) -> int:
        return sum(len(d) for d in self._shard_free)

    @property
    def n_used(self) -> int:
        """Allocated pages, the retained tier included."""
        return self.capacity - self.n_free

    @property
    def n_retained(self) -> int:
        return len(self._retained)

    @property
    def committed(self) -> int:
        """Pages spoken for: allocated (shared pages once) + reserved."""
        return self.n_used + self.reserved

    @property
    def occupancy(self) -> float:
        """Allocated fraction of the allocatable pool."""
        return self.n_used / max(1, self.capacity)

    @property
    def bytes_in_use(self) -> int:
        return self.n_used * self.page_bytes

    def free_pages(self) -> list[int]:
        """The free pages, each shard's in allocation order, shards in turn
        (audit hook)."""
        return [p for d in self._shard_free for p in d]

    # -------------------------------------------------------------- shards

    def shard_of(self, page: int) -> int:
        """The shard holding ``page``: contiguous ranges of ``n_pages //
        shards`` pages."""
        return page // self._pages_per_shard

    def shard_free(self, shard: int) -> int:
        """Free pages in ``shard``."""
        return len(self._shard_free[shard])

    def shard_available(self, shard: int) -> bool:
        """Whether ``alloc(shard=shard)`` can succeed without preemption: a
        free page in the shard, or a retained one reclaim can convert."""
        if self._shard_free[shard]:
            return True
        return any(self.shard_of(p) == shard for p in self._retained)

    # ------------------------------------------------------ retained tier

    def is_retained(self, page: int) -> bool:
        return page in self._retained

    def retained_pages(self) -> list[int]:
        """Retained pages, next-to-reclaim first (audit hook)."""
        return list(self._retained)

    def reclaim_retained(self, n: int, *, shard: int | None = None) -> int:
        """Evict up to ``n`` pages (of ``shard`` only, if given) from the
        oldest end of the retained tier back to the free list
        (``on_release`` fires first, so the prefix index forgets them before
        they can be reused).  Returns how many."""
        done = 0
        for page in list(self._retained):
            if done >= n:
                break
            if shard is not None and self.shard_of(page) != shard:
                continue
            del self._retained[page]
            if self.on_release is not None:
                self.on_release(page)
            self._shard_free[self.shard_of(page)].append(page)
            done += 1
        if done:
            self.reclaim_count += done
            if self.metrics is not None:
                self.metrics.inc("retained_reclaims", done)
            self._update_gauges()
        return done

    # -------------------------------------------------------- reservations

    def reserve(self, n: int, *, owner=None) -> bool:
        """Reserve ``n`` future allocations; False (and no change) when the
        commitment budget cannot guarantee them, after reclaiming retained
        pages as far as that helps."""
        over = self.committed + n - self.capacity
        if over > 0 and self._retained:
            self.reclaim_retained(over)
        if self.committed + n > self.capacity:
            return False
        self.reserved += n
        if owner is not None:
            self._owner_reserved[owner] = self._owner_reserved.get(owner, 0) + n
        self._update_gauges()
        return True

    def release(self, n: int, *, owner=None) -> None:
        """Return a request's never-allocated reservation; releasing more
        than ``owner`` holds raises."""
        if n > self.reserved:
            raise ValueError(f"release({n}) exceeds reserved={self.reserved}")
        if owner is not None:
            held = self._owner_reserved.get(owner, 0)
            if n > held:
                raise ValueError(f"double release: owner {owner!r} releases {n} units but "
                                 f"has {held} reserved")
            if held - n:
                self._owner_reserved[owner] = held - n
            else:
                self._owner_reserved.pop(owner, None)
        self.reserved -= n
        self._update_gauges()

    def owner_reserved(self, owner) -> int:
        """Outstanding tracked reservation units of ``owner`` (audit hook)."""
        return self._owner_reserved.get(owner, 0)

    # ------------------------------------------------------ physical pages

    def _pop_free(self, shard: int | None) -> int:
        """Pop a free page: from ``shard`` when pinned, else round-robin
        across the shards with free pages.  Reclaims from the retained tier
        only when the free list(s) in question are dry."""
        if shard is not None:
            if not self._shard_free[shard]:
                self.reclaim_retained(1, shard=shard)
            if not self._shard_free[shard]:
                raise RuntimeError(f"page pool exhausted in shard {shard} (free={self.n_free} "
                                   f"elsewhere, retained={self.n_retained})")
            return self._shard_free[shard].popleft()
        if not any(self._shard_free):
            self.reclaim_retained(1)
        for off in range(self.shards):
            c = (self._rr + off) % self.shards
            if self._shard_free[c]:
                self._rr = (c + 1) % self.shards
                return self._shard_free[c].popleft()
        raise RuntimeError("page pool exhausted")

    def alloc(self, *, covered: bool = True, owner=None, shard: int | None = None) -> int:
        """Pop a free page (refcount 1, held by ``owner``).

        ``covered=True`` (the serving path) converts one reserved unit, and
        raises when none is outstanding (or, with an ``owner``, when that
        owner has none).  ``covered=False`` (tests, tooling) allocates
        outside any reservation and refuses to push ``committed`` past
        ``capacity``.  ``shard`` pins the page to one shard's range, which
        can run dry while the pool has pages (the engine's affinity-aware
        preemption guards that)."""
        if covered:
            if not self.reserved:
                raise RuntimeError("covered alloc() with no reservation outstanding — the "
                                   "unit would be stolen from the commitment budget")
            if owner is not None:
                held = self._owner_reserved.get(owner, 0)
                if not held:
                    raise RuntimeError(f"covered alloc() by owner {owner!r} exceeds its "
                                       "reservation (0 units left)")
                if held - 1:
                    self._owner_reserved[owner] = held - 1
                else:
                    self._owner_reserved.pop(owner, None)
        else:
            if self.committed >= self.capacity and self._retained:
                self.reclaim_retained(self.committed - self.capacity + 1)
            if self.committed >= self.capacity:
                raise RuntimeError(f"uncovered alloc() would over-commit the pool "
                                   f"(committed={self.committed}, capacity={self.capacity})")
        page = self._pop_free(shard)
        self._refcount[page] = 1
        self._holders[page] = [owner]
        if covered:
            self.reserved -= 1
        self._update_gauges()
        return page

    def retain(self, page: int, *, owner=None) -> bool:
        """Add a reference to an allocated page (prefix sharing), or promote
        a retained page back to committed.  Returns True iff it promoted."""
        if self._refcount[page] <= 0:
            if page in self._retained:
                del self._retained[page]
                self._refcount[page] = 1
                self._holders[page] = [owner]
                self._update_gauges()
                return True
            raise ValueError(f"retain of unallocated page {page}")
        self._refcount[page] += 1
        self._holders[page].append(owner)
        return False

    def refcount(self, page: int) -> int:
        """Current reference count (0 == free or retained); a flush
        destination with refcount > 1 is copied on write first."""
        return int(self._refcount[page])

    def holders(self, page: int) -> list:
        return list(self._holders.get(page, ()))

    def free(self, page: int, *, owner=None) -> None:
        """Drop one reference.  At refcount zero the page moves to the
        retained tier (``retainable`` accepts it) or back to the free list
        (firing ``on_release``).  Freeing a scratch page, a free or retained
        page, or a page ``owner`` does not hold raises."""
        if page < self.n_scratch:
            raise ValueError(f"free of scratch page {page} (pages [0, {self.n_scratch}) "
                             "are per-slot scratch and are never allocated)")
        if self._refcount[page] <= 0:
            raise ValueError(f"double free of page {page} (refcount 0)")
        held = self._holders[page]
        if owner is not None and owner not in held:
            raise ValueError(f"free of page {page} by non-holder {owner!r} (held by {held})")
        held.remove(owner if owner in held else (None if None in held else held[0]))
        self._refcount[page] -= 1
        if self._refcount[page] == 0:
            self._holders.pop(page, None)
            if self.retainable is not None and self.retainable(page):
                self._retained[page] = None  # most recently used end
                self._update_gauges()
                return
            self._shard_free[self.shard_of(page)].append(page)
            self._update_gauges()
            if self.on_release is not None:
                self.on_release(page)


# --------------------------------------------------------------------------
# Device side: adopt bucket-prefill dense caches into the pools, copy on
# write, push page tables.  All in place.
# --------------------------------------------------------------------------


def _ints(vals, device) -> torch.Tensor:
    return upload(np.asarray(vals, np.int64), device)


def adopt_prefill(paged_caches: list, dense_caches: list, *, slot_ids: list[int],
                  lengths: list[int], pages_per_req: list[list[int]], block_n: int,
                  base_blocks: list[int] | None = None) -> list:
    """Splice one bucketed prefill into the paged decode state, in place.

    ``paged_caches`` / ``dense_caches``: the per-stack layer-stacked caches
    of the engine's state and of the just-computed dense prefill (row ``r``
    = request ``r``).  Request ``r``'s first ``lengths[r] // block_n`` dense
    blocks go to pool pages ``pages_per_req[r]``; its residual row and
    occupancy go to decode slot ``slot_ids[r]``.  ``base_blocks[r]`` shared
    leading blocks (prefix sharing) already sit in the pools: the dense
    cache holds only the suffix, and the slot's ``pack_blocks`` becomes
    ``base_blocks[r] + lengths[r] // block_n``.  Page tables are pushed
    separately (:func:`set_page_tables`).  Pools that hold a page range (a
    rank's page-affine pools) take the blocks whose pages lie in it, every
    residual and length all the same."""
    rows, blks, pages = [], [], []
    for r, pgs in enumerate(pages_per_req):
        for j, pg in enumerate(pgs):
            rows.append(r)
            blks.append(j)
            pages.append(pg)
    base = base_blocks if base_blocks is not None else [0] * len(slot_ids)
    pack = [b + ln // block_n for b, ln in zip(base, lengths)]
    res = [ln % block_n for ln in lengths]
    for pc, dc in zip(paged_caches, dense_caches):
        dev = pc.kw.device
        pos, local = pc.local_pages(pages)
        if pos:
            ridx, bidx = _ints([rows[i] for i in pos], dev), _ints([blks[i] for i in pos], dev)
            pidx = _ints(local, dev)
            for f in _qc._PAGED_POOL_FIELDS:
                pool, dn = getattr(pc, f), getattr(dc, f)
                if pool is None:  # shared_kv: no V-side pools
                    continue
                # dn [L, m, H, nb, ...]; indices at dims 1 and 3 -> [N, L, H, ...]
                pool[:, pidx] = dn[:, ridx, :, bidx].movedim(0, 1).to(pool.dtype)
        sidx, rrow = _ints(slot_ids, dev), _ints(range(len(slot_ids)), dev)
        for f in ("k_res", "v_res"):
            buf = getattr(pc, f)
            if buf is not None:
                buf[:, sidx] = getattr(dc, f)[:, rrow].to(buf.dtype)
        pc.pack_blocks[:, sidx] = _ints(pack, dev).to(torch.int32)
        pc.res_len[:, sidx] = _ints(res, dev).to(torch.int32)
    return paged_caches


def cow_pages(paged_caches: list, src: list[int], dst: list[int]) -> list:
    """Copy on write across every stacked paged cache, in place: pool pages
    ``dst[i]`` become bitwise replicas of ``src[i]`` (``qcache.copy_pages``)."""
    return [_qc.copy_pages(pc, src, dst) for pc in paged_caches]


def set_page_tables(paged_caches: list, table: np.ndarray) -> list:
    """Push the host page table ([B, nb_max]) into every stacked paged cache
    with one in-place copy per stack: the layers' tables are views of one
    tensor (``qcache.init_paged_cache(layers=...)``).  The push does not
    wait on the card (``core.device.upload``): it is queued behind the
    decode steps in flight, which read the table it replaces."""
    for pc in paged_caches:
        pt = pc.page_table
        if pt.dim() > 2 and pt.stride(0) == 0:
            pt = pt[0]  # one tensor expanded over the layers
        pt.copy_(upload(np.asarray(table, np.int32), pt.device).expand(pt.shape))
    return paged_caches
