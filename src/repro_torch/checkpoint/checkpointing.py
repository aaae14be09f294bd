"""Async, fault-tolerant checkpointing (no external deps).

A copy of ``repro.checkpoint.checkpointing`` without JAX: the same step
directories, manifest, npz file and flattened key layout, so a checkpoint
written by either package reads back in the other. Leaves are numpy arrays
or torch tensors (copied to host numpy before a save is backgrounded);
restore returns numpy arrays in the template's structure and leaves
placement to the caller.

Layout per step::

    <dir>/step_000123/
        manifest.json      tree structure, shapes, dtypes, write fingerprint
        arrays.npz         flattened {path: array} (per-host shard on real
                           multihost runs; single file here)
        _COMMITTED         sentinel written last — a checkpoint without it is
                           torn and ignored by restore

Guarantees exercised by tests:
  * atomic commit (tmp dir + rename + sentinel),
  * retention (keep last N),
  * corruption fallback (restore skips torn/corrupt checkpoints and falls
    back to the newest valid one),
  * async save (background thread; ``wait()`` joins),
  * arrays are saved unsharded-logical.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

PyTree = Any
_SENTINEL = "_COMMITTED"


def load_latest(directory: str, template: PyTree,
                step: Optional[int] = None
                ) -> Tuple[Optional[int], Optional[PyTree], Dict]:
    """Restore the newest valid checkpoint from ``directory`` — the public
    one-shot read path (serving, analysis) that doesn't want to hold a
    :class:`CheckpointManager` for saves.

    Same semantics as :meth:`CheckpointManager.restore`: newest committed
    step first (or exactly ``step`` if given), torn/corrupt checkpoints
    skipped with fallback to the next older valid one. ``template`` only
    has to describe the subtree the caller wants — extra arrays in the
    checkpoint (say the optimizer state, when serving only needs params)
    are ignored. Returns ``(step, tree, extra)`` or ``(None, None, {})``.

    Strictly read-only: unlike constructing a :class:`CheckpointManager`
    (whose init makes the directory for upcoming saves), a missing
    ``directory`` — e.g. a typo'd path — is left missing, so the mistake
    stays visible on the next run instead of turning into a plausible
    empty checkpoint dir.
    """
    if not os.path.isdir(directory):
        return None, None, {}
    return CheckpointManager(directory).restore(template, step=step)


def _to_host(tree: PyTree) -> PyTree:
    """The tree with every tensor leaf as a host numpy array of its own,
    which no later in-place update of the tensor reaches."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to_host(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if tree is None:
        return None
    if hasattr(tree, "detach"):
        return tree.detach().to("cpu", copy=True).numpy()
    return np.asarray(tree)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}.{k}" if prefix else str(k), node[k])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:                # NamedTuple (before tuple!)
                rec(f"{prefix}.{f}" if prefix else f, getattr(node, f))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}[{i}]", v)
        elif node is None:
            flat[prefix + "#none"] = np.zeros((), np.int8)
        else:
            flat[prefix] = np.asarray(node)

    rec("", tree)
    return flat


def _unflatten_into(template: PyTree, flat: Dict[str, np.ndarray]) -> PyTree:
    """Rebuild values following the template's structure."""

    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}.{k}" if prefix else str(k), node[k])
                    for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[rec(f"{prefix}.{f}" if prefix else f,
                                    getattr(node, f))
                                for f in node._fields])
        if isinstance(node, (list, tuple)):
            vals = [rec(f"{prefix}[{i}]", v) for i, v in enumerate(node)]
            return type(node)(vals) if isinstance(node, tuple) else vals
        if node is None:
            return None
        if prefix + "#none" in flat:
            return None
        return flat[prefix]

    return rec("", template)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, _SENTINEL)):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    # -- save ----------------------------------------------------------

    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None,
             async_: bool = False) -> None:
        # materialize on host *before* backgrounding so the live training
        # buffers can keep mutating
        host_tree = _to_host(tree)

        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_tree, extra or {})

    def _write(self, step: int, tree: PyTree, extra: Dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "paths": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                      for k, v in flat.items()},
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(final, _SENTINEL), "w") as f:
            f.write("ok")
        self._retain()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------

    def restore(self, template: PyTree, step: Optional[int] = None
                ) -> Tuple[Optional[int], Optional[PyTree], Dict]:
        """Restore the newest valid checkpoint (or ``step``). Falls back to
        older checkpoints on corruption. Returns (step, tree, extra)."""
        candidates = ([step] if step is not None
                      else list(reversed(self.steps())))
        for s in candidates:
            try:
                d = self._step_dir(s)
                with open(os.path.join(d, "manifest.json")) as f:
                    manifest = json.load(f)
                with np.load(os.path.join(d, "arrays.npz")) as z:
                    flat = {k: z[k] for k in z.files}
                tree = _unflatten_into(template, flat)
                return s, tree, manifest.get("extra", {})
            except Exception:
                continue
        return None, None, {}
