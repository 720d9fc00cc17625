"""Checkpoint store: atomic, async, elastic (counterpart of
``repro.checkpoint.store``, in its on-disk format).

Format: one directory per step —

    <dir>/step_000123/
        manifest.json   # tree structure, shapes, dtypes, format version
        arrays.npz      # flat {path -> ndarray}, full logical arrays
    <dir>/latest        # text file naming the newest complete step

The flat keys are ``repro``'s: the ``jax.tree_util`` path of each leaf,
its parts joined by ``/`` (dict keys sorted, sequence positions, NamedTuple
field names), so a ``(params, OptState)`` checkpoint written by either
package restores in the other. The manifest's ``treedef`` is a description
of the tree that the port writes and never parses (``repro`` writes its
``PyTreeDef`` there).

* **atomic** — written into ``step_X.tmp-<pid>-<thread>`` then
  ``os.replace``d; the ``latest`` pointer is updated only after the
  directory rename, so a crash mid-write never corrupts a restorable
  checkpoint.
* **async**  — ``CheckpointManager.save_async`` copies to host memory
  synchronously, then serialises on a writer thread.
* **elastic** — arrays are stored whole; ``load_checkpoint`` places each
  on the device of its template leaf.
* **self-pruning** — keeps the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._tree import (tree_flatten_with_path, tree_map,
                               tree_unflatten)

_FORMAT = 2
_SEP = "/"


def _flatten(tree) -> dict[str, Any]:
    return {_SEP.join(str(p) for p in path): leaf
            for path, leaf in tree_flatten_with_path(tree)}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _treedef(tree) -> str:
    """A description of the tree's structure (written, never parsed)."""
    return str(tree_map(lambda _: "*", tree))


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Blocking atomic save of a tree of (device or host) arrays."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + f".tmp-{os.getpid()}-{threading.get_ident()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = dict(
        version=_FORMAT,
        step=step,
        treedef=_treedef(tree),
        keys={k: dict(shape=list(v.shape), dtype=str(v.dtype))
              for k, v in flat.items()},
        written_at=time.time(),
    )
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # latest pointer (atomic via temp + replace)
    lp = os.path.join(directory, "latest")
    with open(lp + ".tmp", "w") as f:
        f.write(f"step_{step:09d}")
    os.replace(lp + ".tmp", lp)
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int):
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and "tmp-" not in d
    )
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    lp = os.path.join(directory, "latest")
    if not os.path.exists(lp):
        return None
    with open(lp) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        return None
    return int(name.split("_")[1])


def load_checkpoint(directory: str, template, *, step: Optional[int] = None):
    """Restore into ``template``'s tree structure. A tensor leaf of the
    template comes back as a tensor on that leaf's device (the elastic
    placement); any other leaf as the stored numpy array."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    z = np.load(os.path.join(path, "arrays.npz"))
    flat_template = _flatten(template)
    missing = set(flat_template) - set(z.files)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    def restore(key, like):
        arr = z[key]
        if not isinstance(like, torch.Tensor):
            return arr
        return torch.from_numpy(np.array(arr)).to(like.device)  # keeps 0-d

    leaves = [restore(k, v) for k, v in flat_template.items()]  # template order
    return tree_unflatten(template, leaves), step


class CheckpointManager:
    """Async wrapper: snapshot synchronously, serialise on a worker thread."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree):
        self.wait()  # one in-flight save at a time
        host = tree_map(_host, tree)  # snapshot now

        def work():
            try:
                save_checkpoint(self.directory, step, host, keep=self.keep)
                with self._lock:
                    self.last_saved = step
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore_or_none(self, template):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return load_checkpoint(self.directory, template, step=step)
