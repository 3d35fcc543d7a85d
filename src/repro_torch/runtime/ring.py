"""Descriptor rings, doorbells, and completion credits (DESIGN.md §12).

The port's copy of ``repro.runtime.ring`` (pure Python, unchanged).

The paper separates *configuration* from *data transfer*: software posts
descriptors into fixed-depth per-link rings and rings a doorbell CSR, while
the engine consumes ring heads and posts completions independently.  This
module is the pointer machinery; the scheduler owns one
:class:`DescriptorRing` per (resource, tenant) pair, and the simulator
prices each doorbell CSR write via ``Link.csr_write_cost``.

The pointer idiom is blue-rdma's ringbufs: head/tail cursors run mod
``2 * depth`` — the extra wrap ("guard") bit distinguishes a full ring from
an empty one without sacrificing a slot (empty: ``head == tail``; full: the
cursors differ by exactly ``depth``).

Credits ARE slots: posting a descriptor consumes one credit, the completion
of the head task returns it.  A post against a full ring either raises
:class:`WouldBlock` (the ``error`` policy) or drains scheduling rounds until
a credit frees (the default ``block`` policy — deadlock-free, because a
dependency must already be submitted, so the oldest pending task always
sits dep-satisfied at its ring head).

Pure Python, no JAX.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["DEFAULT_RING_DEPTH", "WouldBlock", "DescriptorRing", "Completion"]

# Deep enough that the existing single-tenant call sites (serving engines,
# MoE, train, checkpoint) never hit backpressure between flushes; tests use
# depth 2 to exercise the full-ring paths on purpose.
DEFAULT_RING_DEPTH = 256


class WouldBlock(RuntimeError):
    """A descriptor post found its ring out of credits (``error`` policy).

    Carries the ring coordinates so callers can drain one scheduling round
    (``scheduler.step()`` — a completion returns the credit) and repost;
    the ``block`` policy does exactly that internally."""

    def __init__(self, resource: str, tenant: str = "", depth: int = 0):
        self.resource = resource
        self.tenant = tenant
        self.depth = depth
        who = f"{resource}/{tenant}" if tenant else resource
        super().__init__(
            f"descriptor ring {who!r} is full (depth {depth}): no credits "
            "until a completion retires the head task")


class DescriptorRing:
    """One fixed-depth descriptor ring with guard-bit head/tail pointers.

    :meth:`post` is the producer side (descriptor write + doorbell),
    :meth:`pop` the consumer side (dispatch retires the head; its credit
    returns).  ``credits == depth - occupancy`` always."""

    __slots__ = ("name", "depth", "_slots", "_head", "_tail")

    def __init__(self, name: str, depth: int):
        if depth < 1:
            raise ValueError(f"ring {name!r}: depth must be >= 1")
        self.name = name
        self.depth = int(depth)
        self._slots: List[Optional[int]] = [None] * self.depth
        # cursors mod 2*depth: the top (guard) bit disambiguates full/empty
        self._head = 0                   # consumer cursor
        self._tail = 0                   # producer cursor

    @property
    def occupancy(self) -> int:
        return (self._tail - self._head) % (2 * self.depth)

    @property
    def credits(self) -> int:
        return self.depth - self.occupancy

    @property
    def is_empty(self) -> bool:
        return self._head == self._tail

    @property
    def is_full(self) -> bool:
        return self.occupancy == self.depth

    def post(self, task_id: int) -> int:
        """Producer: write one descriptor slot, advance the tail (the
        doorbell write).  Returns the new occupancy."""
        if self.is_full:
            raise WouldBlock(self.name, depth=self.depth)
        self._slots[self._tail % self.depth] = task_id
        self._tail = (self._tail + 1) % (2 * self.depth)
        return self.occupancy

    def head(self) -> Optional[int]:
        """The task id at the consumer head (None when empty)."""
        if self.is_empty:
            return None
        return self._slots[self._head % self.depth]

    def pop(self) -> int:
        """Consumer: retire the head slot; its credit returns."""
        if self.is_empty:
            raise IndexError(f"ring {self.name!r} is empty")
        tid = self._slots[self._head % self.depth]
        self._slots[self._head % self.depth] = None
        self._head = (self._head + 1) % (2 * self.depth)
        return tid

    def __len__(self) -> int:
        return self.occupancy

    def __repr__(self):
        return (f"DescriptorRing({self.name!r}, {self.occupancy}/{self.depth}"
                f", head={self._head}, tail={self._tail})")


@dataclasses.dataclass(frozen=True)
class Completion:
    """One completion-queue entry: the engine retired a ring head.

    ``start_s``/``end_s`` are the simulated span the dispatch occupies —
    computed with exactly the event-driven replay's arithmetic, which is
    what makes the scheduler's incremental makespan bit-equal to
    ``report().makespan`` once the rings are drained."""

    task_id: int
    resource: str
    tenant: str
    round: int
    start_s: float
    end_s: float
