"""Fault-tolerant checkpointing: atomic, asynchronous, device-portable
(PyTorch port).

The twin of ``repro.checkpoint.manager``, with its on-disk format: one
``arrays.npz`` (leaves named by their tree path, ``params/w``) plus a
``meta.json`` whose ``"bf16"`` lists the bf16 leaves (stored bit-cast to
``uint16``) and whose ``"layouts"`` gives the at-rest layout of each
layout-staged leaf.  A checkpoint written by either package restores in
the other bitwise.

* atomic     — write to ``<dir>/tmp.<step>`` then ``os.rename``;
* async      — ``save(..., blocking=False)`` snapshots to host memory (the
               copies finish before the writer thread starts) and writes on
               a background thread;
* portable   — ``restore(..., device=...)`` stages every leaf onto the
               device asked for (the card by default), whatever device wrote
               it: the counterpart of the reference's ``sharding_tree``;
* retention  — keeps the newest ``keep`` checkpoints.

Movement plane: save and restore stage every matrix-shaped leaf through an
``xdma.transfer`` descriptor, so a ``capture()`` trace records the
checkpoint's movements.  ``stage_dtype=`` saves a down-cast copy and
restores through the inverse Cast; ``wire_compress_blocks=`` wraps the wire
in the lossless Compress/Decompress pair; ``stage_layout=`` picks the
at-rest layout (``"auto"``: the autotuner's tiled pick per leaf shape and
dtype; a concrete layout where it fits), recorded in ``meta.json`` so
restore inverts it through the plane.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import _pytree
from repro_torch.core import api as xdma
from repro_torch.core import autotune as XA
from repro_torch.core import layouts as XL
from repro_torch.core import plugins as XP
from repro_torch.core.descriptor import describe

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree",
           "read_layout_specs"]


def _flatten_with_paths(tree) -> Dict[str, Any]:
    return {_pytree.path_key(path): leaf
            for path, leaf in _pytree.flatten_with_paths(tree)}


def _to_numpy(v) -> np.ndarray:
    """A leaf as host numpy; a bf16 tensor as its ``uint16`` bits."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(v)


def _to_tensor(a: np.ndarray, bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy(order="C"))
    return t.view(torch.bfloat16) if bf16 else t


# -- at-rest layout metadata (meta.json "layouts") ---------------------------
def _layout_spec(lay: XL.Layout) -> Dict[str, Any]:
    return {"name": lay.name,
            "tile": list(lay.tile) if lay.tile is not None else None,
            "perm": list(lay.perm) if lay.perm is not None else None,
            "pad": list(lay.pad) if lay.pad is not None else None}


def _layout_from_spec(spec: Dict[str, Any]) -> XL.Layout:
    try:
        lay = XL.by_name(spec["name"])
        if not lay.is_auto:
            return lay
    except (KeyError, ValueError):
        pass
    return XL.Layout(tuple(spec["tile"]) if spec["tile"] is not None else None,
                     spec["name"],
                     perm=tuple(spec["perm"]) if spec["perm"] is not None
                     else None,
                     pad=tuple(spec["pad"]) if spec["pad"] is not None
                     else None)


def read_layout_specs(directory: str) -> Dict[str, XL.Layout]:
    """The per-leaf at-rest layouts a checkpoint was staged with (empty for
    checkpoints written without layout staging)."""
    with open(os.path.join(directory, "meta.json")) as f:
        specs = json.load(f).get("layouts", {})
    return {k: _layout_from_spec(s) for k, s in specs.items()}


def save_pytree(tree, directory: str,
                layouts: Optional[Dict[str, XL.Layout]] = None) -> None:
    os.makedirs(directory, exist_ok=True)
    arrays, meta = {}, {}
    for k, v in _flatten_with_paths(tree).items():
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            meta[k] = "bfloat16"
        arrays[k] = _to_numpy(v)
    np.savez(os.path.join(directory, "arrays.npz"), **arrays)
    doc: Dict[str, Any] = {"bf16": meta}
    if layouts:
        doc["layouts"] = {k: _layout_spec(l) for k, l in layouts.items()}
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(doc, f)


def restore_pytree(template, directory: str, device=None, *,
                   physical: bool = False):
    """Restore into the structure of ``template`` (leaves with ``shape``)
    on ``device``: the card when None, the host when ``"cpu"``.

    Leaves saved with an at-rest layout (``meta.json`` ``layouts``) are
    un-staged to logical on ``device`` by default; ``physical=True`` returns
    them in their stored physical form (the manager then routes the
    un-staging relayout through the movement plane)."""
    dev = torch.device("cuda" if device is None else device)
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        data = {k: z[k] for k in z.files}
    with open(os.path.join(directory, "meta.json")) as f:
        bf16 = json.load(f)["bf16"]
    layouts = read_layout_specs(directory)

    leaves = []
    for path, leaf in _pytree.flatten_with_paths(template):
        key = _pytree.path_key(path)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        a = _to_tensor(data[key], key in bf16).to(dev)
        lay = layouts.get(key)
        if lay is not None:
            logical = tuple(lay.logical_shape(tuple(a.shape)))
            if logical != tuple(leaf.shape):
                raise ValueError(f"{key}: ckpt logical shape {logical} != "
                                 f"template {tuple(leaf.shape)}")
            if not physical:
                a = lay.to_logical(a).contiguous()
        elif tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: ckpt shape {tuple(a.shape)} != "
                             f"template {tuple(leaf.shape)}")
        leaves.append(a)
    return _pytree.unflatten(template, leaves)


# -- host<->device staging descriptors (the checkpoint's XDMA tasks) ---------
@functools.lru_cache(maxsize=None)
def _stage_desc(cast_to: Optional[str], compress_blocks: Optional[int],
                layout: Optional[XL.Layout] = None):
    """One leaf's staging DMA: a plain copy by default, a Cast on the stream
    when the snapshot dtype differs, Compress/Decompress around the wire
    when block compression is on, the relayout fused on the wire when an
    at-rest ``layout`` is picked."""
    pre = []
    post = []
    if compress_blocks:
        pre.append(XP.Compress(block_rows=compress_blocks))
        post.append(XP.Decompress())
    if cast_to is not None:
        pre.insert(0, XP.Cast(cast_to))
    return describe("MN", layout if layout is not None else "MN",
                    pre=tuple(pre), post=tuple(post))


@functools.lru_cache(maxsize=None)
def _unstage_desc(layout: XL.Layout, cast_to: Optional[str]):
    """The restore half of a layout-staged leaf: at-rest tiled -> logical,
    casting back to the template dtype on the same stream."""
    pre = (XP.Cast(cast_to),) if cast_to is not None else ()
    return describe(layout, "MN", pre=pre)


def _name(dtype) -> str:
    return XL.dtype_info(dtype)[1]


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, *,
                 stage_dtype=None, wire_compress_blocks: Optional[int] = None,
                 stage_layout=None):
        self.root = root
        self.keep = keep
        self.stage_dtype = stage_dtype
        self.wire_compress_blocks = wire_compress_blocks
        if isinstance(stage_layout, str) and stage_layout != "auto":
            stage_layout = XL.by_name(stage_layout)
        self.stage_layout = stage_layout
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _at_rest_layout(self, a: torch.Tensor) -> Optional[XL.Layout]:
        """The at-rest layout for one matrix leaf, or None (plain MN)."""
        if self.stage_layout is None or a.ndim != 2:
            return None
        if isinstance(self.stage_layout, XL.Layout):
            try:
                self.stage_layout.check(tuple(a.shape))
            except ValueError:
                return None                     # a leaf it cannot tile: plain
            return self.stage_layout
        return XA.best_layout(tuple(a.shape), a.dtype, tiled_only=True)

    def stage_descriptor(self, a: torch.Tensor, cast_to=None,
                         layout: Optional[XL.Layout] = None):
        """The descriptor that stages matrix leaf ``a`` (``a.ndim >= 2``)."""
        blocks = self.wire_compress_blocks
        if blocks and a.shape[-2] % blocks:
            blocks = None                      # unaligned leaf: plain wire
        if cast_to is not None and (XL.torch_dtype(cast_to) == a.dtype
                                    or not a.dtype.is_floating_point):
            cast_to = None
        return _stage_desc(None if cast_to is None else _name(cast_to),
                           blocks, layout)

    def _stage(self, a: torch.Tensor, cast_to=None,
               layout: Optional[XL.Layout] = None):
        """Move one leaf through the plane, on the leaf's device.  Only
        matrix-shaped leaves are XDMA tasks; scalars and vectors (step
        counters, biases) ride along as they are."""
        if a.ndim < 2:
            return a
        return xdma.transfer(a, self.stage_descriptor(a, cast_to, layout))

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Snapshot ``tree`` (tensors on any device) through the plane, on
        each leaf's device, then write it (on a thread unless
        ``blocking``)."""
        self.wait()
        cast = self.stage_dtype
        layouts: Dict[str, XL.Layout] = {}
        devices = set()

        def stage(path, x):
            a = torch.as_tensor(x)
            devices.add(a.device)
            lay = self._at_rest_layout(a)
            if lay is not None:
                layouts[_pytree.path_key(path)] = lay
            return self._stage(a, cast, lay).cpu()

        snapshot = _pytree.tree_map_with_path(stage, tree)
        for dev in devices:
            if dev.type == "cuda":
                # the writer thread reads host memory the copies filled
                torch.cuda.synchronize(dev)
        if blocking:
            self._write(step, snapshot, layouts)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, snapshot, layouts),
                daemon=True)
            self._thread.start()

    def _write_guarded(self, step, snapshot, layouts):
        try:
            self._write(step, snapshot, layouts)
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def _write(self, step: int, snapshot, layouts) -> None:
        tmp = os.path.join(self.root, f"tmp.{step}")
        final = os.path.join(self.root, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(snapshot, tmp, layouts)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- read ---------------------------------------------------------------
    def steps(self):
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                      if d.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, template, device=None):
        """Read the checkpoint and stage every leaf onto ``device`` (the card
        when None) through the plane, casting back to the template dtype
        where the snapshot was saved down-cast and un-staging at-rest
        layouts on the stream."""
        self.wait()
        dev = torch.device("cuda" if device is None else device)
        directory = os.path.join(self.root, f"step_{step:010d}")
        specs = read_layout_specs(directory)
        if specs:
            tree = restore_pytree(template, directory, dev, physical=True)

            def unstage(path, a, t):
                lay = specs.get(_pytree.path_key(path))
                td = getattr(t, "dtype", None)
                if lay is None:
                    return self._stage(a, td)
                cast = None
                if (td is not None and XL.torch_dtype(td) != a.dtype
                        and a.dtype.is_floating_point
                        and XL.torch_dtype(td).is_floating_point):
                    cast = _name(td)
                return xdma.transfer(a, _unstage_desc(lay, cast))

            return _pytree.tree_map_with_path(unstage, tree, template)
        tree = restore_pytree(template, directory, dev)
        return _pytree.tree_map_with_path(
            lambda _, a, t: self._stage(a, getattr(t, "dtype", None)),
            tree, template)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:010d}"),
                          ignore_errors=True)
