"""Async, atomic checkpointing (the counterpart of
``src/repro/checkpoint/manager.py``), in the reference's on-disk layout:

    <dir>/step_<N>/
        manifest.json       treedef, n_leaves, step, shapes, dtypes
        leaf_<i>.npy        one array per leaf, in the flatten order

so that a tree saved by either package restores in the other. Leaves are
in ``repro_torch.tree``'s flatten order, which is JAX's for a dict tree
(keys sorted, lists in order, None no leaf). bf16 leaves are stored as a
uint8 view with the dtype in the manifest (numpy has no bf16).

  * atomic — written to ``step_<N>.tmp``, then renamed; a crash mid-write
    never corrupts the latest checkpoint;
  * async — the device→host copy runs on the caller's thread (ordered
    with the step), the file I/O on a background thread; ``wait()``
    joins it before the next save;
  * self-describing — the manifest pins shapes and dtypes, and a
    mismatch against the template fails loudly.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from .. import tree as T


def _to_host(leaf):
    """A copy of a leaf on the host: numpy, or a CPU torch tensor for bf16
    (a copy: the optimizer updates the parameters in place)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", copy=True)
        return leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.array(leaf)


def _write(host: list, treedef: str, path: Path, step: int | None) -> None:
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {
        "treedef": treedef,
        "n_leaves": len(host),
        "step": step,
        "shapes": [list(h.shape) for h in host],
        "dtypes": ["bfloat16" if isinstance(h, torch.Tensor) else str(h.dtype) for h in host],
    }
    for i, h in enumerate(host):
        if isinstance(h, torch.Tensor):  # bf16: the byte view, as the reference stores it
            h = h.contiguous().reshape(h.shape or (1,)).view(torch.uint8).numpy()
        np.save(tmp / f"leaf_{i}.npy", h)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if path.exists():
        shutil.rmtree(path)
    os.rename(tmp, path)


def save_tree(tree, path: Path, step: int | None = None) -> None:
    """Synchronous atomic save of one tree."""
    _write([_to_host(x) for x in T.leaves(tree)], T.treedef_str(tree), path, step)


def restore_tree(template, path: Path):
    """Restore into the structure of ``template``, each leaf on its
    template leaf's device (a module comes back as a new module)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    leaves_t = T.leaves(template)
    if manifest["n_leaves"] != len(leaves_t):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, template {len(leaves_t)}")
    out = []
    for i, tmpl in enumerate(leaves_t):
        arr = torch.from_numpy(np.load(path / f"leaf_{i}.npy"))
        want = manifest["dtypes"][i]
        if want == "bfloat16":  # the byte-view round trip
            arr = arr.view(torch.bfloat16).reshape(manifest["shapes"][i])
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {i}: ckpt {tuple(arr.shape)} != template {tuple(tmpl.shape)}")
        dev = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
        out.append(arr.to(dev))
    return T.unflatten_like(template, out)


class CheckpointManager:
    """Step-indexed async manager with retention."""

    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def _steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if p.is_dir()
                      and not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree, blocking: bool = False) -> None:
        self.wait()
        # device→host on the caller's thread (ordered with the step), I/O async
        host = [_to_host(x) for x in T.leaves(tree)]
        treedef = T.treedef_str(tree)

        def _write_and_gc():
            _write(host, treedef, self._step_dir(step), step)
            self._gc()

        if blocking:
            _write_and_gc()
        else:
            self._thread = threading.Thread(target=_write_and_gc, daemon=True)
            self._thread.start()

    def restore(self, template, step: int | None = None):
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return restore_tree(template, self._step_dir(step)), step

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self._steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
