"""Bytes moved and bytes held by one device's step, counted as its ops
dispatch (PyTorch port: the twin of ``repro.launch.hlo_cost``).

The reference walks XLA's optimised HLO: the HBM bytes of an op are its
operands plus its outputs at fusion granularity, multiplied through the
loops' trip counts, and XLA's buffer assignment gives the step's argument,
output, temp and peak bytes.  The port runs eagerly, and every op it
dispatches is one kernel on the card, so :class:`OpCost` counts at
dispatch: a ``TorchDispatchMode`` that sees each aten op below autograd,
beside ``FlopCounterMode`` in the same single run of the step
(:func:`repro_torch.launch.dryrun.count_step`).  It works the same on
``meta`` tensors (the dry run) and on real ones (a test's rank on the CPU):
nothing it counts reads a value.

**Bytes moved** (``op_bytes``): for every op, the bytes of its tensor
operands read plus the bytes of its outputs written, a tensor's bytes being
its elements over the dimensions it does not broadcast (a stride of 0 reads
one element's worth).

* Views move nothing: ``view``, ``as_strided``, ``expand``, ``permute``,
  ``slice``, ``select``, ``t``, ``_unsafe_view``, ``detach``, the in-place
  view ops (``unsqueeze_``, ``transpose_``) and the allocations that write
  nothing (``empty``, ``empty_strided``).
* An in-place op writes the tensor it is handed, which may be a view: a
  ``copy_`` into a slice bills the slice, not its base (hlo_cost's dynamic
  update slice).  ``copy_``, ``fill_``, ``zero_`` and the random fills
  write without reading; any other in-place op reads and writes its
  target; an ``out=`` argument is written, not read.
* The scatters (``index_put_``, ``index_copy_``, ``index_add_``,
  ``index_fill_``, ``scatter_``, ``scatter_add_``, ``scatter_reduce_``)
  bill the elements they address, not the buffer: a cache's slot write
  (``layers/attention._write_slots``) costs the slot.  The accumulating
  ones read those elements too.
* Loops run eagerly, so each trip is counted as it runs: no trip-count
  rule is needed, and none is applied.

**Bytes held**: every storage is keyed by its identity, not by a tensor
(a view keeps its base alive), and is live from the op that allocates it
until the last tensor on it dies (a ``weakref.finalize`` on the storage,
which PyTorch keeps as one Python object while any tensor holds it).  The
step's ``arguments`` (the state and the batch) are live when it starts.

* ``argument``: the bytes of the storages of the arguments;
* ``output``: of the storages of what the step returns (those it shares
  with the arguments too: a cache leaf returned as it was handed);
* ``peak``: the largest live total over the step, arguments included;
* ``temp``: ``peak - argument``.

Against XLA's ``memory_analysis()``: ``argument_size_in_bytes`` and
``output_size_in_bytes`` are the same sets of buffers, but XLA may alias
an output with a donated argument, where the eager step holds the old
state and the new one together; XLA's ``temp_size_in_bytes`` is the size
of its scratch allocation, laid out by buffer assignment so that buffers
whose lives do not overlap share bytes, and ``peak_memory_in_bytes`` the
highest point of that plan.  The eager step frees a buffer when its last
reference dies and never fuses, so its activations are each their own
buffer and its ``peak`` counts them all at once where their lives meet;
what a kernel allocates inside itself (a reduction's scratch, cuBLAS's
workspace) is not seen.  On the card, ``torch.cuda.max_memory_allocated``
over the step also rounds each block up and may hand a request a larger
free block; ``chip_smoke.py`` holds the two within 3 % + 256 MiB.

**Kernels count as the card runs them.**  A hand-written kernel's wrapper
and a collective are marked with :func:`one_op`: on a CPU tensor, and on
a ``meta`` one while an :class:`OpCost` counts (:func:`plain_on`; a meta
tensor raises there otherwise), the wrapper runs its kernel's plain
version (a collective the meta mesh's shapes), whose ops would otherwise
count one by one.  Under :func:`one_op` the ops inside neither count nor
hold bytes; the call counts once, its tensor arguments read and its
outputs written, and its outputs' storages become live.  A bracket, not a ``torch.library`` custom op with a fake
kernel: the wrappers take layouts, descriptors and mesh axes, which a
custom op's schema cannot carry, and a bracket counts the CPU run (the
plain version) and the meta run alike, so a real rank's count equals its
meta twin's.  FLOPs are ``FlopCounterMode``'s, inner ops included.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import weakref
from collections import Counter
from typing import Any, Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCost", "one_op", "plain_on", "tensor_bytes", "tensors"]

# allocations and bookkeeping that move no bytes (the views are told by
# their schema: OpOverload.is_view, or the inplace_view tag)
_FREE = {"_unsafe_view", "empty", "empty_strided", "new_empty",
         "new_empty_strided", "empty_like", "lift_fresh", "set_", "resize_",
         "_reshape_alias", "resolve_conj", "resolve_neg", "is_same_size",
         "_has_compatible_shallow_copy_type", "record_stream"}
# in-place ops that write their target without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
               "exponential_", "bernoulli_", "geometric_", "log_normal_",
               "cauchy_"}
# in-place scatters: they bill the elements they address
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "index_add_",
             "index_fill_", "scatter_", "scatter_add_", "scatter_reduce_"}
_ACCUMULATE = {"index_add_", "scatter_add_", "scatter_reduce_"}

_STATE = threading.local()


def tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor in ``obj``: a tensor, or tuples, lists, dicts and
    dataclasses of them (a datapath's ``CTensor``), depth first."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from tensors(o)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of ``t``: its elements over the
    dimensions it does not broadcast (stride 0), times the element size."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _active() -> "OpCost | None":
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


def plain_on(x: torch.Tensor) -> bool:
    """Whether a kernel's wrapper takes its plain version for ``x``: on
    the CPU, and on meta under an active :class:`OpCost` (the dry run's
    shapes); elsewhere it launches its kernel or raises."""
    return x.device.type == "cpu" or (x.device.type == "meta"
                                      and _active() is not None)


def one_op(fn):
    """Count a call of ``fn`` as one op of the device under an active
    :class:`OpCost` (a kernel wrapper, a collective): its tensor arguments
    read, its outputs written and live, nothing of what it runs inside."""
    @functools.wraps(fn)
    def counted(*args, **kwargs):
        cost = _active()
        if cost is None or cost._quiet:
            return fn(*args, **kwargs)
        cost._quiet += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            cost._quiet -= 1
        ins = list(tensors((args, kwargs)))
        outs = list(tensors(out))
        cost._add(fn.__qualname__, sum(map(tensor_bytes, ins))
                  + sum(map(tensor_bytes, outs)))
        cost._hold(outs, ins)
        return out
    return counted


def _bound(func, args, kwargs) -> Dict[str, Any]:
    """The op's arguments by their schema names."""
    out = dict(kwargs)
    for a, v in zip(func._schema.arguments, args):
        out[a.name] = v
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _region(name: str, target: torch.Tensor, arg: Dict[str, Any]) -> int:
    """The elements a scatter addresses in ``target``."""
    if name in ("index_put_", "_index_put_impl_"):
        # the index tensors' broadcast shape over the dims they take (a
        # mask its elements over as many dims, each a slot it may write),
        # times the dims they leave whole (past their end, or a None)
        shapes, taken, d = [], set(), 0
        for i in arg["indices"]:
            if i is None:
                d += 1
                continue
            mask = i.dtype == torch.bool
            span = i.dim() if mask else 1
            shapes.append((i.numel(),) if mask else tuple(i.shape))
            taken.update(range(d, d + span))
            d += span
        whole = [s for j, s in enumerate(target.shape) if j not in taken]
        return _numel(torch.broadcast_shapes(*shapes)) * _numel(whole)
    if name in ("index_copy_", "index_add_"):
        return arg["source"].numel()
    if name == "index_fill_":
        dim = arg["dim"] % max(target.dim(), 1)
        return arg["index"].numel() * (target.numel()
                                       // max(target.shape[dim], 1))
    return arg["index"].numel()                   # the scatters


class OpCost(TorchDispatchMode):
    """Count the bytes a step's ops move and the bytes it holds.

    ``with OpCost(arguments) as cost: out = step()`` then
    ``cost.result(out)``: ``{"op_bytes", "argument", "output", "temp",
    "peak"}``.  ``by_op`` holds the bytes moved by op name.  ``live`` is
    the bytes held now (arguments included)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.op_bytes = 0
        self.by_op: Counter = Counter()
        self.live = 0
        self.peak = 0
        self.argument = 0
        self._quiet = 0
        self._held: Dict[int, weakref.finalize] = {}
        self._hold(list(tensors(arguments)), ())
        self.argument = self.live

    # -- bytes held --------------------------------------------------------
    def _free(self, key: int, nbytes: int) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= nbytes

    def _hold(self, outs: List[torch.Tensor], ins) -> None:
        """Make the storages of ``outs`` live, but those of ``ins`` (an
        op's result that aliases its operand) and those already held."""
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in self._held or key in seen:
                continue
            nbytes = s.nbytes()
            self._held[key] = weakref.finalize(s, self._free, key, nbytes)
            self.live += nbytes
        self.peak = max(self.peak, self.live)

    # -- bytes moved -------------------------------------------------------
    def _add(self, name: str, nbytes: int) -> None:
        self.op_bytes += nbytes
        self.by_op[name] += nbytes

    def _bill(self, name, func, args, kwargs, ins, out) -> int:
        schema = getattr(func, "_schema", None)
        if schema is None:                         # not an aten op
            return (sum(map(tensor_bytes, ins))
                    + sum(map(tensor_bytes, tensors(out))))
        if (name in _FREE or func.is_view
                or torch.Tag.inplace_view in func.tags):
            return 0
        written = [a for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if not written:
            return (sum(map(tensor_bytes, ins))
                    + sum(map(tensor_bytes, tensors(out))))
        arg = _bound(func, args, kwargs)
        targets = [arg[a.name] for a in written
                   if isinstance(arg.get(a.name), torch.Tensor)]
        read_ids = {id(t) for t in targets}
        total = 0
        for a, t in zip(written, targets):
            if name in _SCATTERS and a.name == "self":
                n = _region(name, t, arg) * t.element_size()
                again = name in _ACCUMULATE or (
                    name in ("index_put_", "_index_put_impl_")
                    and arg.get("accumulate", False))
                total += n * (2 if again else 1)
                if name.startswith("scatter") and isinstance(
                        arg.get("src"), torch.Tensor):
                    src = arg["src"]
                    read_ids.add(id(src))
                    total += arg["index"].numel() * src.element_size()
            elif a.kwarg_only or name in _WRITE_ONLY:
                total += tensor_bytes(t)           # written, not read
            else:
                total += 2 * tensor_bytes(t)       # read and written
        # what the op returns besides its targets (a batch norm's output
        # beside the running stats it updates)
        held = {id(t.untyped_storage()) for t in targets}
        total += sum(tensor_bytes(o) for o in tensors(out)
                     if id(o.untyped_storage()) not in held)
        return total + sum(tensor_bytes(t) for t in ins
                           if id(t) not in read_ids)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ins = list(tensors((args, kwargs)))
        packet = getattr(func, "overloadpacket", None)
        name = packet.__name__ if packet is not None else str(func)
        nbytes = self._bill(name, func, args, kwargs, ins, out)
        if nbytes:
            self._add(name, nbytes)
        self._hold(list(tensors(out)), ins)
        return out

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        if not hasattr(_STATE, "stack"):
            _STATE.stack = []
        _STATE.stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _STATE.stack.remove(self)

    def result(self, out=None) -> Dict[str, int]:
        """The step's counts, ``out`` what it returned."""
        stores = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in tensors(out)}
        for fin in self._held.values():
            fin.detach()
        self._held.clear()
        return {"op_bytes": self.op_bytes, "argument": self.argument,
                "output": sum(stores.values()), "temp":
                self.peak - self.argument, "peak": self.peak}
