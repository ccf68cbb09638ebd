"""Async checkpointing with atomic manifests and elastic restore (PyTorch
port of ``repro.checkpoint.checkpointer``).

Layout (one directory per step), the reference's::

    ckpt_dir/
      step_000128.tmp/          # in-flight write (never restored from)
        manifest.json           # {step, meta, written_at, leaves: {path:
        0000_params.embed.w.npy #   {file, shape, dtype}}}
        ...
      step_000128/              # atomic rename once every leaf is on disk

One ``.npy`` per leaf, named by its path in the tree (dict keys and list
indices joined by "/") and numbered in JAX's flatten order (a dict's keys
sorted), so the files are the reference's. A bf16 leaf is written as its uint16 bits (numpy
has no bfloat16 without ``ml_dtypes``), and the manifest records
``bfloat16``.

Fault-tolerance contract:
  * a crash mid-write leaves only a ``.tmp`` dir, which is never restored;
  * ``latest_step`` returns the newest complete step;
  * restore is elastic: leaves are whole on disk, and ``restore`` can give
    a rank its block of each (``block``, as ``sharding.rules.local_params``
    gives a rank its blocks of a parameter tree), whatever mesh wrote them.

``save`` copies every leaf to the host synchronously (the device->host
snapshot) and writes the files on a background thread when
``async_write``, overlapping the write with the next training steps.

Under a mesh of ranks (``save(block=, like=)``, every rank calling it)
each sharded leaf is gathered whole over its axes and rank 0 alone takes
the host copies and writes them (asynchronously if ``async_write``);
``save`` ends in a barrier, and so does ``wait`` once such a save was
made, so every rank returns from ``wait`` after rank 0's write is done.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.params import tree_paths

_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of axis names or None."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _flatten(tree) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the tree's order (``tree_paths``); a tuple of
    axis names is a leaf (a logical-axes tree's)."""
    return tree_paths(tree, is_leaf=_is_axes)


def _rebuild(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return leaves[prefix]


def _sanitize(name: str) -> str:
    return name.replace("/", ".")


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy, and the dtype the manifest records."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf ``np.load`` read (C order, as written) as a tensor."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, ckpt_dir: str | Path, keep_last: int = 3,
                 async_write: bool = True):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._ranked = False          # a save under a mesh was made

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             block=None, like=None) -> None:
        """Snapshot ``tree`` at ``step``. Returns once the host copies are
        taken; the disk write may continue in the background.

        ``block``: ``tree`` holds this rank's blocks under these logical
        axes (``restore``'s ``block``) of the whole leaves ``like`` (the
        same structure, e.g. on the ``meta`` device); every rank of the
        current sharding context calls it, and the leaves are gathered
        whole (``sharding.collectives.gather_block``) for rank 0 to
        write."""
        self.wait()                           # one in-flight write at a time
        flat = _flatten(tree)
        if block is not None:
            import torch.distributed as dist
            from ..sharding import collectives as coll
            axes, whole = dict(_flatten(block)), dict(_flatten(like))
            with torch.no_grad():
                flat = [(n, coll.gather_block(t, tuple(whole[n].shape),
                                              axes[n])) for n, t in flat]
            self._ranked = True
            if dist.get_rank() != 0:
                dist.barrier()
                return
        host = [(n, *_to_numpy(t)) for n, t in flat]
        del flat
        if block is not None:
            dist.barrier()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: list, meta: Optional[dict]) -> None:
        try:
            tmp = self.dir / f"step_{step:06d}.tmp"
            final = self.dir / f"step_{step:06d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "meta": meta or {},
                        "written_at": time.time(), "leaves": {}}
            for i, (name, arr, dtype) in enumerate(host):
                fname = f"{i:04d}_{_sanitize(name)[:120]}.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][name] = {
                    "file": fname, "shape": list(arr.shape), "dtype": dtype}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)            # atomic commit
            self._gc()
        except BaseException as e:            # surfaced on the next wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._ranked:
            import torch.distributed as dist
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep_last] if self.keep_last > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:06d}", ignore_errors=True)

    # --------------------------------------------------------------- restore

    def list_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device=None, block=None) -> Any:
        """Load ``step`` into the structure of ``like`` (tensors, on the
        ``meta`` device or any other), on ``device`` (the card unless the
        caller passes ``"cpu"``).

        ``block``: a tree of logical axes in ``like``'s structure (e.g.
        ``opt_state_axes(params_logical_axes(cfg))``); each whole leaf is
        then narrowed to this rank's block under the current sharding
        context, as ``sharding.rules.local_params`` narrows a parameter
        tree. That is the elastic path: a checkpoint written from any mesh
        loads onto the current one."""
        dev = resolve_device(device)
        d = self.dir / f"step_{step:06d}"
        manifest = json.loads((d / "manifest.json").read_text())
        like_flat = _flatten(like)
        names = {n for n, _ in like_flat}
        missing = names - set(manifest["leaves"])
        extra = set(manifest["leaves"]) - names
        if missing or extra:
            raise ValueError(
                f"checkpoint/model structure mismatch: missing="
                f"{sorted(missing)[:5]} extra={sorted(extra)[:5]}")
        ctx = None
        if block is not None:
            from ..sharding.rules import current_ctx
            ctx = current_ctx()
            if ctx is None:
                raise ValueError("restore(block=...) needs a sharding "
                                 "context")
            axes = dict(_flatten(block))
        loaded = {}
        for name, leaf in like_flat:
            info = manifest["leaves"][name]
            if list(leaf.shape) != info["shape"]:
                raise ValueError(f"checkpoint/model structure mismatch: "
                                 f"{name} is {info['shape']} on disk, "
                                 f"{list(leaf.shape)} in the model")
            t = _from_numpy(np.load(d / info["file"]), info["dtype"])
            if ctx is not None:
                t = ctx.block(t, axes[name])
            loaded[name] = t.to(dev, copy=True)
        return _rebuild(like, loaded)

    def restore_meta(self, step: int) -> dict:
        d = self.dir / f"step_{step:06d}"
        return json.loads((d / "manifest.json").read_text())["meta"]
