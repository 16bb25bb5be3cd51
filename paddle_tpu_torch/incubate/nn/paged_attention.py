"""Paged KV-cache attention (counterpart of
``paddle_tpu/incubate/nn/paged_attention.py``).

KV lives in a shared pool of fixed-size pages and each sequence owns a
block table of page ids:

- pools:        k/v  ``[num_pages, n_head, page_size, head_dim]``
- block table:  ``[batch, max_pages_per_seq]`` page ids
- seq lens:     ``[batch]``

:class:`PageAllocator` is the host-side bookkeeping; the step functions
are plain torch (a gather by ``tables`` and a length mask, as in the
reference, where they are XLA compositions with no Pallas kernel).
Unlike the reference's functional ``.at[].set``, pool writes here are in
place (``index_put_``): the functions return the same pool tensors they
were given.
"""
from __future__ import annotations

import torch

__all__ = ["PageAllocator", "paged_attend", "paged_decode_step",
           "paged_prefill_append"]

_NARROW = (torch.bfloat16, torch.float16)


class PageAllocator:
    """Host-side page bookkeeping for a shared pool.

    Page 0 is the reserved GARBAGE page: released slots' block tables
    point at it, so a batch-wide append from an inactive row scatters
    into page 0 and can never corrupt a live sequence.  The allocator
    therefore hands out pages ``1 .. num_pages-1``.

    Invariant (the "no leak" contract): every page is either in the
    free list or owned by exactly one slot.  ``release`` is idempotent
    and guards against double-frees.
    """

    def __init__(self, num_pages, batch, max_pages_per_seq):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = int(num_pages)
        self.batch = int(batch)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self._free = list(range(num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._owned = [[] for _ in range(batch)]

    @property
    def num_free_pages(self):
        return len(self._free)

    def owned_pages(self, b):
        return list(self._owned[b])

    def pages_needed(self, n_tokens, page_size):
        return -(-int(n_tokens) // int(page_size))

    def can_allocate(self, b, need):
        """Can slot `b` grow to `need` pages right now?"""
        have = len(self._owned[b])
        if need <= have:
            return True
        if need > self.max_pages_per_seq:
            return False
        return need - have <= len(self._free)

    def allocate(self, b, need):
        """Grow slot `b` to `need` pages; returns [(slot_idx, page_id)]
        newly assigned entries for the caller's block-table update."""
        have = len(self._owned[b])
        if need <= have:
            return []
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"sequence {b} needs {need} pages but max_pages_per_seq "
                f"is {self.max_pages_per_seq}")
        if need - have > len(self._free):
            raise RuntimeError("paged KV cache: out of pages")
        assigned = []
        while len(self._owned[b]) < need:
            pg = self._free.pop()
            self._free_set.discard(pg)
            assigned.append((len(self._owned[b]), pg))
            self._owned[b].append(pg)
        return assigned

    def release(self, b):
        """Return slot `b`'s pages to the pool; returns the freed page
        ids.  Idempotent; raises on a double-free."""
        pages = self._owned[b]
        if not pages:
            return []
        dupes = [p for p in pages if p in self._free_set]
        if dupes:
            raise RuntimeError(
                f"paged KV cache: double-free of page(s) {dupes} "
                f"releasing slot {b}")
        self._free.extend(reversed(pages))
        self._free_set.update(pages)
        self._owned[b] = []
        return pages

    def check_invariant(self):
        """All pages accounted for exactly once (free or owned)."""
        owned = [p for o in self._owned for p in o]
        if len(set(owned)) != len(owned):
            raise RuntimeError("paged KV cache: page owned twice")
        if set(owned) & self._free_set:
            raise RuntimeError("paged KV cache: page both owned and free")
        if len(owned) + len(self._free) != self.num_pages - 1:
            raise RuntimeError(
                f"paged KV cache: leak — {len(owned)} owned + "
                f"{len(self._free)} free != {self.num_pages - 1}")
        return True


def paged_attend(q, k_pages, v_pages, tables, lens, page_size):
    """``[b, h, 1, d]`` queries over each row's gathered pages, masked at
    ``lens``, scaled by 1/sqrt(d). bf16/fp16 pools accumulate both
    contractions in f32 and round once at the output."""
    b, h, _one, d = q.shape
    sc = 1.0 / float(d) ** 0.5
    tables = tables.long()
    P = tables.shape[1]
    k_seq = k_pages[tables].transpose(1, 2).reshape(b, h, P * page_size, d)
    v_seq = v_pages[tables].transpose(1, 2).reshape(b, h, P * page_size, d)
    pos = torch.arange(P * page_size, device=q.device)
    mask = pos[None, None, None, :] < lens.long()[:, None, None, None]
    qs = q * sc
    if q.dtype in _NARROW:
        s = torch.matmul(qs.float(), k_seq.float().transpose(-1, -2))
    else:
        s = torch.matmul(qs, k_seq.transpose(-1, -2))     # [b, h, 1, Pp]
    s = torch.where(mask, s.float(), torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if q.dtype in _NARROW:
        return torch.matmul(p.float(), v_seq.float()).to(q.dtype)
    return torch.matmul(p, v_seq)                         # [b, h, 1, d]


def paged_decode_step(q, k_new, v_new, k_pages, v_pages, tables, lens,
                      page_size):
    """Write each row's new token at position ``lens[b]`` (in place),
    attend over ``lens[b] + 1`` tokens. Returns (out, k_pages, v_pages);
    the caller owns the lens update.

    Rows of empty slots have an all-zero table and length 0, so they all
    write to page 0, offset 0: with repeated indices which write lands
    is not deterministic on CUDA, which is harmless because page 0 is
    never read for a live row."""
    lens = lens.long()
    tables = tables.long()
    page_ids = tables.gather(1, (lens // page_size)[:, None])[:, 0]   # [b]
    offs = lens % page_size
    k_pages[page_ids, :, offs] = k_new[:, :, 0].to(k_pages.dtype)
    v_pages[page_ids, :, offs] = v_new[:, :, 0].to(v_pages.dtype)
    out = paged_attend(q, k_pages, v_pages, tables, lens + 1, page_size)
    return out, k_pages, v_pages


def paged_prefill_append(k_new, v_new, k_pages, v_pages, tables, lens,
                         page_size):
    """Batched prompt scatter, in place: token t of row b lands in page
    ``tables[b, t // page_size]`` at offset ``t % page_size``; positions
    ``>= lens[b]`` go to the garbage page 0 (repeated indices there: see
    :func:`paged_decode_step`). k_new/v_new ``[b, h, S, d]``. Returns
    (k_pages, v_pages)."""
    b, h, S, d = k_new.shape
    t = torch.arange(S, device=k_new.device)
    # clamp in case S spans more pages than the table width — the
    # valid mask routes those to garbage anyway
    page_idx = torch.clamp(t // page_size, max=tables.shape[1] - 1)
    offs = t % page_size
    page_ids = tables.long()[:, page_idx]                  # [b, S]
    valid = t[None, :] < lens.long()[:, None]
    page_ids = torch.where(valid, page_ids, 0).reshape(-1)
    flat_offs = offs.repeat(b)
    kt = k_new.transpose(1, 2).reshape(b * S, h, d).to(k_pages.dtype)
    vt = v_new.transpose(1, 2).reshape(b * S, h, d).to(v_pages.dtype)
    k_pages[page_ids, :, flat_offs] = kt
    v_pages[page_ids, :, flat_offs] = vt
    return k_pages, v_pages
