"""Fault-tolerant checkpointing: the twin of ``repro.train.checkpoint``,
with the same files on disk, so a checkpoint written by either package
loads in the other.

  * atomic publish: write to ``step_N.tmp/``, fsync the manifest,
    rename to ``step_N/``; a crash mid-write never corrupts the latest
    checkpoint, and a stray ``.tmp`` directory is ignored;
  * one ``.npy`` file per array, named by its flattened path
    (``params/...``, ``opt/step``, ``opt/mu/...``: dict keys sorted,
    NamedTuple fields in order);
  * async save: the device-to-host copy is synchronous (a blocking
    ``.to("cpu", copy=True)``), so the caller may change its tensors as
    soon as ``save`` returns; the file write runs on a background
    thread, one at a time, in submission order;
  * integrity: each array's SHA-256 in ``manifest.json`` (with its
    shape, dtype and the caller's ``extra``), verified on load;
  * auto-resume: ``latest_step()`` finds the newest complete checkpoint;
    ``keep`` bounds how many stay on disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import convert, tree


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):   # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _host(v) -> np.ndarray:
    """A host copy of one leaf (a tensor on any device, an array or a
    scalar) that later changes to the leaf cannot reach."""
    if isinstance(v, torch.Tensor):
        return convert.tensor_to_numpy(v)
    return np.array(v)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        # serializes join-then-spawn: without it, two racing save()
        # calls can both observe the old writer, both spawn, and
        # interleave their tmp-dir publishes under the same step path
        self._lock = threading.Lock()

    # -- save ---------------------------------------------------------------

    def save(self, step: int, params, opt_state=None, extra: Optional[
            Dict[str, Any]] = None, blocking: bool = False):
        """Copy to host memory synchronously, write asynchronously.
        Any in-flight background writer is joined *before* the next
        write starts (one writer at a time, in submission order)."""
        flat = _flatten({"params": params, "opt": opt_state or {}})
        host = {k: _host(v) for k, v in flat.items() if v is not None}
        with self._lock:
            self._join_locked()   # one in-flight save at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}))
            self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        with self._lock:
            self._join_locked()

    def _join_locked(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, np.ndarray],
               extra: Dict[str, Any]):
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "arrays": {}}
        for name, arr in host.items():
            fn = name.replace("/", "__") + ".npy"
            path = os.path.join(tmp, fn)
            np.save(path, arr)
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["arrays"][name] = {
                "file": fn, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "sha256": digest}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):          # idempotent re-save of a step
            shutil.rmtree(tmp)
        else:
            os.rename(tmp, final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- load ---------------------------------------------------------------

    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d,
                                                "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def load(self, step: Optional[int] = None, verify: bool = True
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Returns (flat arrays {'params/...': np.ndarray}, extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for name, info in manifest["arrays"].items():
            path = os.path.join(d, info["file"])
            if verify:
                with open(path, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                if digest != info["sha256"]:
                    raise IOError(f"checksum mismatch for {name} at "
                                  f"step {step}: {path}")
            out[name] = np.load(path)
        return out, manifest.get("extra", {})


def _leaf(arr: np.ndarray, tpl, name: str):
    """The saved array ``arr`` as the template leaf ``tpl`` holds it: a
    tensor on its device and in its dtype (a leaf that is no tensor
    stays the array)."""
    if not isinstance(tpl, torch.Tensor):
        return arr
    if arr.shape != tuple(tpl.shape):
        raise ValueError(f"{name}: saved shape {arr.shape}, the "
                         f"template's {tuple(tpl.shape)}")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # np.save stores a bfloat16 array (in either package) as 2-byte
        # records, and np.load gives them back untyped; the manifest
        # names the dtype
        return (torch.from_numpy(arr.view(np.int16).copy())
                .view(torch.bfloat16).to(device=tpl.device, dtype=tpl.dtype))
    # (table_from_numpy lifts a 0-d array to 1-d: reshape back)
    return convert.table_from_numpy(arr, dtype=tpl.dtype,
                                    device=tpl.device).reshape(arr.shape)


def unflatten_into(flat: Dict[str, np.ndarray], template):
    """Rebuild a tree matching ``template`` from the flat ``params/...``
    names: each tensor leaf on the template leaf's device, in its
    dtype (bfloat16 arrays bit for bit)."""
    return tree.unflatten(template, [
        _leaf(flat[k], v, k)
        for k, v in _flatten({"params": template}).items()])
