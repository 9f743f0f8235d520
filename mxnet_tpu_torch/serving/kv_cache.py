"""Block-paged KV-cache pool (the port of ``mxnet_tpu/serving/kv_cache.py``).

All streams share ONE device pool of fixed-size blocks (``block_size``
token slots each); a per-request block table names which pool blocks hold
the request's tokens, in position order. Device memory scales with tokens
actually cached, admission is a free-list pop, and release is O(blocks)
with zero copying.

Layout (one pool per engine): torch tensors ``(num_layers, num_blocks,
block_size, num_heads, head_dim)`` for K and V, on the engine's device.
The prefill and decode steps write into them IN PLACE (where the JAX
package donates the pages into each jitted step and rebinds the result).
Block 0 is the reserved TRASH block — padded table entries and padded
batch rows point at it, so masked lanes of a bucketed step scatter their
garbage somewhere no reader ever trusts (readers mask by context length;
the pool hands block 0 to no request).

Prefix sharing: every allocated block carries a REFCOUNT. Full prefill
blocks are content-hashed into a pool-level prefix index — the digest
chains token ids through the block's position base, so only a same-tokens
same-positions prefix can ever match (position embeddings are baked into
the cached K/V). A new request maps the longest indexed block-aligned
prefix into its table via :meth:`prefix_match` (incref), and
``free``/preempt decrements — a block returns to the free list only when
its refcount reaches zero, at which point its index entry is dropped.
Shared blocks are COPY-ON-WRITE: :meth:`cow` hands a writer a private
bit-exact copy first. The trash block is never refcounted, never indexed,
never shared.

Fragmentation accounting: fixed-size blocks make external fragmentation
impossible by construction, so "defrag" reduces to accounting for
INTERNAL fragmentation — allocated-but-unused slots in each request's tail
block — exposed as the ``serving.kv_blocks_frag_slots`` gauge.
"""
import hashlib
import threading

import numpy as np
import torch

from .. import context, fault, telemetry
from ..analysis import witness
from ..base import MXNetError, torch_dtype


class KVCacheOOM(MXNetError):
    """The block pool cannot satisfy an allocation (classified so the
    scheduler can preempt / the engine can fail the request instead of
    dying inside a step)."""


class KVBlockPool:
    """Device KV block pool + thread-safe host-side free-list allocator
    with block refcounts and a content-hash prefix index. ``device`` None
    means the card (:func:`..context.default_device`)."""

    def __init__(self, num_layers, num_blocks, block_size, num_heads,
                 head_dim, dtype=np.float32, device=None,
                 prefix_cache=True):
        if num_blocks < 2:
            raise ValueError("KVBlockPool needs >= 2 blocks (block 0 is the "
                             "reserved trash block)")
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = torch_dtype(dtype)
        self.device = context.resolve(device)
        self.prefix_cache = bool(prefix_cache)
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        #: the device pages; prefill/decode write into them in place
        self.k_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self._lock = threading.Lock()
        self._lock = witness.declare(
            "mxnet_tpu_torch.serving.kv_cache.KVBlockPool._lock", self._lock)
        # LIFO free list, block 0 excluded (trash)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        # block id -> refcount, allocated blocks only (never block 0)
        self._ref = {}
        # content-hash prefix index: chained digest -> block id holding
        # that full block's K/V, plus the reverse map for O(1) removal
        # when the block's refcount hits zero
        self._prefix = {}
        self._block_digest = {}
        # per-pool tallies (the registry counters with the same names are
        # process-global; stats() must read only this pool's traffic)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_blocks = 0
        self.cow_copies = 0
        telemetry.gauge("serving.kv_blocks_total").set(self.num_usable)
        with self._lock:
            self._refresh_gauges_locked()

    # ---- capacity -------------------------------------------------------
    @property
    def num_usable(self):
        """Allocatable blocks (pool size minus the trash block)."""
        return self.num_blocks - 1

    def available(self):
        with self._lock:
            return len(self._free)

    def used(self):
        with self._lock:
            return self.num_usable - len(self._free)

    def nbytes(self):
        """Device bytes the pool pins (K + V)."""
        per = (self.num_layers * self.num_blocks * self.block_size
               * self.num_heads * self.head_dim * self.dtype.itemsize)
        return 2 * per

    def block_nbytes(self):
        """Device bytes ONE block pins across layers (K + V) — the unit
        every shared reference saves."""
        return 2 * (self.num_layers * self.block_size * self.num_heads
                    * self.head_dim * self.dtype.itemsize)

    def blocks_for(self, num_tokens):
        """Blocks needed to hold ``num_tokens`` cache slots."""
        return -(-int(num_tokens) // self.block_size)

    # ---- alloc / free ---------------------------------------------------
    def alloc(self, n):
        """Pop ``n`` blocks off the free list (each born with refcount 1);
        raises :class:`KVCacheOOM` (allocating nothing) when fewer than
        ``n`` are free."""
        n = int(n)
        # chaos: forced allocator exhaustion, checked OUTSIDE the pool lock
        if fault.hit("kv_oom") is not None:
            telemetry.counter("serving.kv_blocks_alloc_failures").inc()
            raise KVCacheOOM(
                "KV block pool exhausted (fault-injected kv_oom): want %d "
                "blocks" % n)
        with self._lock:
            if n > len(self._free):
                telemetry.counter("serving.kv_blocks_alloc_failures").inc()
                raise KVCacheOOM(
                    "KV block pool exhausted: want %d blocks, %d free of %d "
                    "usable (%d-token slots each)"
                    % (n, len(self._free), self.num_usable, self.block_size))
            got = [self._free.pop() for _ in range(n)]
            for b in got:
                self._ref[b] = 1
            telemetry.counter("serving.kv_blocks_allocs").inc(n)
            self._refresh_gauges_locked()
            self._check_invariants_locked()
            return got

    def free(self, blocks):
        """Drop one reference per listed block. A block returns to the
        free list (and its prefix-index entry is dropped) only when its
        refcount reaches ZERO. Double-free and trash-free are hard errors."""
        blocks = [int(b) for b in blocks]
        with self._lock:
            released = 0
            for b in blocks:
                if b <= 0 or b >= self.num_blocks:
                    raise ValueError("free of invalid block id %d" % b)
                rc = self._ref.get(b, 0)
                if rc <= 0:
                    raise ValueError("double free of block %d" % b)
                if rc == 1:
                    del self._ref[b]
                    self._drop_index_locked(b)
                    self._free.append(b)
                    released += 1
                else:
                    self._ref[b] = rc - 1
            if released:
                telemetry.counter("serving.kv_blocks_frees").inc(released)
            self._refresh_gauges_locked()
            self._check_invariants_locked()
            return released

    # ---- refcounts ------------------------------------------------------
    def refcount(self, b):
        """Current reference count of ``b`` (0 when free/never allocated)."""
        with self._lock:
            return self._ref.get(int(b), 0)

    def incref(self, blocks):
        """Add one reference per listed block (each must be allocated)."""
        with self._lock:
            for b in blocks:
                b = int(b)
                rc = self._ref.get(b, 0)
                if b <= 0 or rc <= 0:
                    raise ValueError(
                        "incref of unallocated block %d (trash and free "
                        "blocks cannot be shared)" % b)
                self._ref[b] = rc + 1
            self._refresh_gauges_locked()
            self._check_invariants_locked()

    def reclaimable(self, blocks):
        """How many of ``blocks`` would actually return to the free list
        if freed now — only those whose refcount is exactly 1."""
        with self._lock:
            return sum(1 for b in blocks if self._ref.get(int(b), 0) == 1)

    def cow(self, b):
        """Copy-on-write: hand the caller a PRIVATE copy of block ``b``
        before a write. Sole owner (refcount 1) -> ``b`` itself, no copy.
        Shared -> allocate a fresh block, copy the K/V pages bit-exactly
        on the device (in place), drop one reference from ``b``, return the
        new id. Raises :class:`KVCacheOOM` when the free list is dry."""
        b = int(b)
        with self._lock:
            rc = self._ref.get(b, 0)
            if b <= 0 or rc <= 0:
                raise ValueError("cow of unallocated block %d" % b)
            if rc == 1:
                return b
            if not self._free:
                telemetry.counter("serving.kv_blocks_alloc_failures").inc()
                raise KVCacheOOM(
                    "KV block pool exhausted: copy-on-write of shared "
                    "block %d needs a free block, 0 free of %d usable"
                    % (b, self.num_usable))
            nb = self._free.pop()
            self._ref[nb] = 1
            self._ref[b] = rc - 1
            # device-side page copy into the private block; the writer's
            # table swaps b -> nb after this returns
            self.k_pages[:, nb] = self.k_pages[:, b]
            self.v_pages[:, nb] = self.v_pages[:, b]
            self.cow_copies += 1
            telemetry.counter("serving.prefix_cow_copies").inc()
            telemetry.counter("serving.kv_blocks_allocs").inc()
            self._refresh_gauges_locked()
            self._check_invariants_locked()
            return nb

    # ---- prefix index ---------------------------------------------------
    def _digests(self, tokens):
        """Chained content digest per FULL block of ``tokens``: digest i
        covers tokens[0 : (i+1)*block_size] plus the position base i."""
        bs = self.block_size
        out = []
        h = hashlib.sha1()
        for i in range(len(tokens) // bs):
            h.update(b"%d|" % i)
            h.update(np.asarray(tokens[i * bs:(i + 1) * bs],
                                np.int64).tobytes())
            out.append(h.digest())
        return out

    def prefix_match(self, tokens):
        """Longest indexed block-aligned prefix of ``tokens``: returns the
        matched block ids IN POSITION ORDER with one reference taken on
        each (the caller owns them exactly like ``alloc`` output). Empty
        list when the index is cold or disabled."""
        if not self.prefix_cache:
            return []
        digests = self._digests(tokens)
        with self._lock:
            self.prefix_lookups += 1
            telemetry.counter("serving.prefix_lookups").inc()
            got = []
            for d in digests:
                b = self._prefix.get(d)
                if b is None:
                    break
                rc = self._ref.get(b, 0)
                if rc <= 0:
                    raise MXNetError(
                        "prefix index invariant violated: indexed block %d "
                        "has no references" % b)
                self._ref[b] = rc + 1
                got.append(b)
            if got:
                self.prefix_hits += 1
                self.prefix_hit_blocks += len(got)
                telemetry.counter("serving.prefix_hits").inc()
                telemetry.counter("serving.prefix_hit_blocks").inc(len(got))
            self._refresh_gauges_locked()
            self._check_invariants_locked()
            return got

    def prefix_insert(self, tokens, blocks):
        """Register a freshly prefilled request's FULL blocks under their
        chain digests. First writer wins: a digest already indexed is
        skipped, as is any block already indexed under another digest."""
        if not self.prefix_cache:
            return 0
        digests = self._digests(tokens)
        added = 0
        with self._lock:
            for d, b in zip(digests, blocks):
                b = int(b)
                if d in self._prefix or b in self._block_digest:
                    continue
                if b <= 0 or self._ref.get(b, 0) <= 0:
                    raise MXNetError("prefix_insert of unallocated block %d"
                                     % b)
                self._prefix[d] = b
                self._block_digest[b] = d
                added += 1
            self._refresh_gauges_locked()
            self._check_invariants_locked()
        return added

    def _drop_index_locked(self, b):
        d = self._block_digest.pop(b, None)
        if d is not None:
            self._prefix.pop(d, None)

    def prefix_stats(self):
        """This pool's prefix-sharing snapshot (engine stats())."""
        with self._lock:
            shared = [rc for rc in self._ref.values() if rc > 1]
            saved_blocks = sum(rc - 1 for rc in shared)
            return {
                "enabled": self.prefix_cache,
                "lookups": self.prefix_lookups,
                "hits": self.prefix_hits,
                "hit_rate": (self.prefix_hits / self.prefix_lookups
                             if self.prefix_lookups else None),
                "hit_blocks": self.prefix_hit_blocks,
                "shared_blocks": len(shared),
                "kv_bytes_saved": saved_blocks * self.block_nbytes(),
                "cow_copies": self.cow_copies,
                "index_size": len(self._prefix),
            }

    # ---- accounting -----------------------------------------------------
    def _refresh_gauges_locked(self):
        telemetry.gauge("serving.kv_blocks_used").set(
            self.num_usable - len(self._free))
        telemetry.gauge("serving.kv_blocks_free").set(len(self._free))
        shared = [rc for rc in self._ref.values() if rc > 1]
        telemetry.gauge("serving.prefix_shared_blocks").set(len(shared))
        telemetry.gauge("serving.prefix_kv_bytes_saved").set(
            sum(rc - 1 for rc in shared) * self.block_nbytes())

    def _check_invariants_locked(self):
        # every usable block is exactly one of: free, or referenced; the
        # trash block is neither, and never indexed or shared
        if len(self._free) + len(self._ref) != self.num_usable:
            raise MXNetError(
                "KV pool accounting drift: %d free + %d referenced != %d "
                "usable" % (len(self._free), len(self._ref), self.num_usable))
        if 0 in self._ref or 0 in self._block_digest:
            raise MXNetError("trash block must never be refcounted or indexed")
        if len(self._prefix) != len(self._block_digest):
            raise MXNetError("prefix index maps out of sync")
