"""Host-side page allocator for the paged, quantized pool cache.

A copy of ``repro/serving/paged.py`` (the port imports nothing of the JAX
package). The device side (core/cache.py paged family) never allocates: it
reads and writes pages strictly through the per-row page table, redirecting
folds whose block has no page to the reserved TRASH page. THIS class is the only
authority over which physical arena page belongs to which pool row, and it
runs on the host BETWEEN chunks — exactly where the scheduler already does
its slot bookkeeping, so allocation adds no device sync.

Invariants (tests/test_torch_paged.py holds this copy to the JAX package's
allocator on the same alloc/free sequences):

* a page is owned by at most one row at a time (no double-allocation, no
  cross-row aliasing);
* every page handed out by `alloc` comes back through `free_row` — the
  free list plus all row lists always partition the usable pages (no
  leaks);
* the TRASH page (id `n_pages - 1`) is never allocated;
* freed pages are scrubbed (the `scrub` callback — the engine zeroes the
  arena pages + scales on device) BEFORE they return to the free list, so
  a page can never leak one request's KV bytes into the next tenant.

Allocation is all-or-nothing per call: a request that cannot get all the
pages it asked for gets none (the scheduler then sheds it with the
`pages_exhausted` reason, or raises where the JAX package would preempt
under page pressure, rather than wedging half-allocated).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence


class PageAllocator:
    """Free-list allocator over a page arena whose last page is TRASH."""

    def __init__(self, n_pages: int, *,
                 scrub: Optional[Callable[[Sequence[int]], None]] = None):
        if n_pages < 2:
            raise ValueError("arena needs >= 2 pages (1 usable + TRASH)")
        self.n_pages = n_pages
        self.trash_page = n_pages - 1
        # LIFO free list: recently scrubbed pages are reused first (their
        # zeroed bytes are most likely still resident in cache)
        self._free: List[int] = list(range(n_pages - 2, -1, -1))
        self._rows: Dict[int, List[int]] = {}
        self._scrub = scrub

    # -- introspection ------------------------------------------------------

    @property
    def usable_pages(self) -> int:
        """Pages that can ever be allocated (arena minus TRASH)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    def pages_of(self, row: int) -> List[int]:
        """The row's pages in block order (a copy)."""
        return list(self._rows.get(row, ()))

    def owned_rows(self) -> List[int]:
        return [r for r, pages in self._rows.items() if pages]

    # -- allocation ---------------------------------------------------------

    def alloc(self, row: int, n: int) -> Optional[List[int]]:
        """Append `n` pages to `row`'s table, all-or-nothing. Returns the
        new page ids (possibly empty for n == 0), or None when fewer than
        `n` pages are free — in which case nothing is allocated."""
        if n < 0:
            raise ValueError(f"alloc of negative page count {n}")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._rows.setdefault(row, []).extend(pages)
        return pages

    def free_row(self, row: int) -> int:
        """Release all of `row`'s pages: scrub first (zero the device bytes
        — the zero-before-reuse invariant), then return them to the free
        list. Returns the number of pages released."""
        pages = self._rows.pop(row, [])
        if not pages:
            return 0
        if self._scrub is not None:
            self._scrub(pages)
        self._free.extend(pages)
        return len(pages)

    # -- consistency (test / debug surface) ---------------------------------

    def check(self) -> None:
        """Assert the partition invariant: free list and row lists are
        disjoint, cover no page twice, and never touch TRASH."""
        seen = set(self._free)
        if len(seen) != len(self._free):
            raise AssertionError("free list holds duplicate pages")
        for row, pages in self._rows.items():
            for p in pages:
                if p in seen:
                    raise AssertionError(
                        f"page {p} of row {row} is double-booked")
                seen.add(p)
        if self.trash_page in seen:
            raise AssertionError("TRASH page was allocated or freed")
        if seen != set(range(self.usable_pages)):
            raise AssertionError("pages leaked: free+rows != usable arena")


def pages_needed(tokens: int, block_size: int) -> int:
    """Pages a row needs to hold `tokens` committed tokens: one page per
    completed-or-started block (ceil division). The raw ring holds the
    current incomplete block, but its page must exist BEFORE the fold that
    completes it, so capacity planning rounds up."""
    return -(-tokens // block_size)
