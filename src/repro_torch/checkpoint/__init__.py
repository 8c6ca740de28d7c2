"""Async, committed checkpoints of a tree of tensors.

The port of ``repro.checkpoint`` with its on-disk layout and rules, one
directory per step::

    <dir>/step_00000400/
        manifest.json        # step, tree structure, leaf shapes/dtypes
        arrays.npz           # flat {index -> ndarray} (full logical arrays)
        DONE                 # commit marker written last

* **Commit marker**: ``DONE`` is written after a flush and fsync of the
  payload and the manifest, in a temporary directory renamed into place;
  :meth:`CheckpointManager.latest_step` ignores uncommitted directories,
  so a preempted writer is never restored from.
* **Async**: :meth:`CheckpointManager.save` snapshots every leaf to host
  memory (``.cpu()``) synchronously, then writes on a daemon thread;
  :meth:`~CheckpointManager.wait` joins it (and raises its error) before
  the next save.
* **Retention**: ``keep_last`` committed steps are kept; older ones are
  removed after each commit.
* **Restore** into the structure of ``like``: a changed tree (another leaf
  count or structure) or a changed shape raises.

bfloat16 leaves go to disk as ``uint16`` (numpy has no bfloat16) and come
back through the manifest's logical dtype. The manifest's ``treedef`` is
the port's own structure string (:func:`tree_structure_json`), not JAX's
treedef, so a checkpoint of the JAX package does not load here, nor one of
the port there (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim import tree_leaves, tree_map

#: numpy cannot hold these dtypes: stored bit-cast to a same-width integer,
#: restored through the manifest's logical dtype
_WIRE_VIEW = {"bfloat16": (torch.int16, np.uint16)}

_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8,
    torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool)}


def tree_structure_json(tree) -> str:
    """The tree's structure as a string: dicts by their keys, lists,
    tuples and NamedTuples (by name), ``*`` a leaf, None."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{tree_structure_json(v)}"
                              for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        name = type(tree).__name__ if hasattr(tree, "_fields") else \
            ("list" if isinstance(tree, list) else "tuple")
        return f"{name}(" + ",".join(tree_structure_json(v) for v in tree) + ")"
    return "None" if tree is None else "*"


def _to_wire(t: torch.Tensor) -> np.ndarray:
    view = _WIRE_VIEW.get(str(t.dtype).removeprefix("torch."))
    if view is not None:
        return t.view(view[0]).numpy().view(view[1])
    return t.numpy()


def _from_wire(a: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype in _WIRE_VIEW:
        return torch.from_numpy(a.view(np.int16)).view(_DTYPES[logical_dtype])
    return torch.from_numpy(a)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if (name.startswith("step_")
                    and os.path.exists(os.path.join(full, "DONE"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save -----------------------------------------------------------
    def _write(self, step: int, host_leaves, manifest: dict) -> None:
        try:
            final = self._step_dir(step)
            tmp = tempfile.mkdtemp(dir=self.directory,
                                   prefix=f".tmp_step_{step}_")
            arrays = {str(i): _to_wire(x) for i, x in enumerate(host_leaves)}
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "DONE"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, step: int, tree, async_: bool = True) -> None:
        """Snapshot ``tree`` (a tree of tensors) as checkpoint ``step``."""
        self.wait()
        leaves, treedef = tree_leaves(tree), tree_structure_json(tree)
        # the synchronous device -> host snapshot (a copy also of a CPU
        # tensor: training goes on updating its own)
        host = [t.detach().to("cpu", copy=True).contiguous() for t in leaves]
        manifest = {
            "step": step, "treedef": treedef,
            "leaves": [{"shape": list(t.shape),
                        "dtype": str(t.dtype).removeprefix("torch.")}
                       for t in host],
            "format": 1,
        }
        if async_:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, manifest), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, manifest)
            self.wait()

    # -- restore ----------------------------------------------------------
    def restore(self, like, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the structure of ``like``, each leaf on its ``like``
        leaf's device; returns (tree, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in "
                                    f"{self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like_leaves = tree_leaves(like)
        treedef = tree_structure_json(like)
        if len(manifest["leaves"]) != len(like_leaves):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, target "
                f"structure has {len(like_leaves)} — incompatible config")
        if manifest["treedef"] != treedef:
            raise ValueError("checkpoint tree structure differs from the "
                             "target's — incompatible config")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            arrays = [_from_wire(z[str(i)], spec["dtype"])
                      for i, spec in enumerate(manifest["leaves"])]
        for a, spec in zip(arrays, manifest["leaves"]):
            if list(a.shape) != spec["shape"]:
                raise ValueError("manifest/payload shape mismatch")
        for a, l in zip(arrays, like_leaves):
            if tuple(a.shape) != tuple(l.shape):
                raise ValueError(
                    f"checkpoint leaf {tuple(a.shape)} vs model "
                    f"{tuple(l.shape)} — config changed between save and "
                    "restore")
        it = iter(a.to(l.device) for a, l in zip(arrays, like_leaves))
        return tree_map(lambda _: next(it), like), step


def checksum(tree) -> str:
    """Content hash of a tree of tensors (test/debug helper)."""
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(_to_wire(leaf.detach().cpu().contiguous()).tobytes())
    return h.hexdigest()[:16]
