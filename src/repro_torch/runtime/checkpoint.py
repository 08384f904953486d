"""Fault-tolerant checkpointing: atomic, step-tagged, resumable.

Layout (the reference's, so that a checkpoint of either package restores
in the other):
  <dir>/step_000123/arrays.npz     flattened tree ('/'-joined key paths)
  <dir>/step_000123/manifest.json  step, dtype/shape index
  <dir>/LATEST                     committed step number (written last)

A tree is nested dicts, tuples and lists of tensors or numpy arrays; a
tuple's or list's key is its index (``(params, opt_state)`` gives
``0/embed``, ``1/m/embed``, ``1/step``).  A bfloat16 leaf is stored as its
raw 2-byte bits under the npz descriptor ``<V2`` — the bytes the
reference's writer stores for a jax bfloat16 array — and recorded as
``"bfloat16"`` in the manifest; restore reads the manifest's dtype, so a
bfloat16 tree round-trips bitwise (the reference's own restore cannot
cast ``V2`` back).

Writes go to step_*.tmp and are renamed into place before LATEST is
updated, so a host failure mid-write can never corrupt the restore path —
restore always reads the last committed step.  Old steps are pruned with
`keep` retention.  A background-thread `save_async` overlaps the host-side
serialization with the next training step (the device->host copy is the
only synchronous part).  ``write_seconds`` records each committed write's
host seconds (files, rename and pointer).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_BF16 = "bfloat16"


class _Bf16Bits:
    """A bfloat16 leaf on the host: its bits as uint16 (numpy has no
    bfloat16 without ml_dtypes, and ``Tensor.numpy()`` refuses one)."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits
        self.shape = bits.shape


def _host(leaf):
    """A leaf copied to the host: numpy, or `_Bf16Bits` for bfloat16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Bf16Bits(t.view(torch.int16).numpy().view(np.uint16).copy())
        return t.numpy().copy()
    arr = np.asarray(leaf)
    if arr.dtype.name == _BF16:  # a jax/ml_dtypes array given directly
        return _Bf16Bits(arr.view(np.uint16).copy())
    return arr


def _items(node):
    if isinstance(node, dict):
        return sorted(node.items())
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix: str = "") -> dict:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _map_with_key(fn, tree, prefix: str = ""):
    items = _items(tree)
    if items is None:
        return fn(prefix, tree)
    out = [(k, _map_with_key(fn, v, f"{prefix}/{k}" if prefix else str(k)))
           for k, v in items]
    if isinstance(tree, dict):
        return dict(out)
    return type(tree)(v for _, v in out)


def _write_npz(path: Path, flat: dict) -> None:
    """``np.savez`` (stored, zip64 members), with a bfloat16 leaf written
    as its bits under the descriptor ``<V2``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if isinstance(val, _Bf16Bits):
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": val.shape})
                    fid.write(np.ascontiguousarray(val.bits).astype("<u2").tobytes())
                else:
                    np.lib.format.write_array(fid, np.asanyarray(val),
                                              allow_pickle=False)


def _dtype_name(val) -> str:
    return _BF16 if isinstance(val, _Bf16Bits) else str(val.dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._write_lock = threading.Lock()  # serialize sync vs async writers
        self.write_seconds: list[float] = []  # each committed write's

    # ------------------------------------------------------------- save
    def save(self, step: int, tree) -> Path:
        return self._write(step, {k: _host(v) for k, v in _flatten(tree).items()})

    def save_async(self, step: int, tree) -> None:
        flat = {k: _host(v) for k, v in _flatten(tree).items()}  # device -> host sync
        self.wait()
        self._thread = threading.Thread(target=self._write, args=(step, flat))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict) -> Path:
        with self._write_lock:
            return self._write_locked(step, flat)

    def _write_locked(self, step: int, flat: dict) -> Path:
        t0 = time.perf_counter()
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        _write_npz(tmp / "arrays.npz", flat)
        manifest = {
            "step": step,
            "arrays": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                       for k, v in flat.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit of the step directory
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, self.dir / "LATEST")  # atomic pointer flip
        self._prune()
        self.write_seconds.append(time.perf_counter() - t0)
        return final

    def _prune(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if not p.name.endswith(".tmp")]

    def latest_step(self) -> int | None:
        marker = self.dir / "LATEST"
        if not marker.exists():
            return None
        step = int(marker.read_text().strip())
        return step if (self.dir / f"step_{step:09d}").exists() else None

    def restore(self, template, step: int | None = None):
        """Restore into the structure of ``template``: a tensor leaf comes
        back as a tensor of the template's dtype on the template's device,
        any other leaf as the stored numpy array.  Returns (tree, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        folder = self.dir / f"step_{step:09d}"
        dtypes = {k: v["dtype"] for k, v in json.loads(
            (folder / "manifest.json").read_text())["arrays"].items()}
        with np.load(folder / "arrays.npz") as z:
            def one(key, leaf):
                arr = z[key]
                if dtypes[key] == _BF16:
                    t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
                elif isinstance(leaf, torch.Tensor):
                    t = torch.from_numpy(arr)
                else:
                    return arr
                if isinstance(leaf, torch.Tensor):
                    return t.to(device=leaf.device, dtype=leaf.dtype)
                return t

            return _map_with_key(one, template), step
