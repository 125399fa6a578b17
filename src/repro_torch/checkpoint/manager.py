"""Fault-tolerant numpy-based checkpointing, in the reference's format.

The on-disk layout is the reference package's, so a step written by
either package reads in the other:

  * atomic: write to ``step_<n:010d>.tmp/`` then ``os.rename`` to
    ``step_<n:010d>/`` (a crashed save never shadows the previous
    checkpoint); orphan ``.tmp`` directories are swept at start;
  * integrity: ``manifest.json`` records dtype, shape and CRC32 per array
    of ``arrays.npz``, verified on restore;
  * bfloat16 is stored as a uint16 view with dtype ``"bfloat16"`` in the
    manifest (npz has no native bf16) and read back as a torch bfloat16
    tensor;
  * keep_last_k garbage collection;
  * ``async_=True`` writes on a background thread.  ``save`` takes the
    host copy of every leaf (``.detach().cpu().numpy()``), its CRC32 and
    the npz bytes synchronously, so later mutation of the saved tree is
    safe and the thread never touches a CUDA tensor: it only writes the
    bytes, fsyncs and renames.  Those calls release the interpreter lock,
    so a write overlaps a host-bound caller (a sweep's launch loop, its
    numpy evaluation) without taking turns with it.

Trees are nested dicts, lists and tuples whose leaves are torch tensors,
numpy arrays or numpy / Python scalars, flattened under ``//``-joined
keys (dict keys, list / tuple indices).  ``restore`` places each tensor
leaf on its abstract leaf's device unless ``device=`` says otherwise;
numpy leaves stay numpy.  (The reference's ``shardings=`` has no
counterpart: the port has no sharded layer.)
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

_SEP = "//"


class CheckpointCorruptError(IOError):
    """A checkpoint failed integrity verification.

    Raised whenever the on-disk state of a step is unusable: a truncated
    or unparseable manifest.json, an array named by the restore tree but
    absent from the manifest or the npz payload, or a CRC32 mismatch.  The
    message names the offending array (or file) and the step.  Subclasses
    IOError, so ``except IOError`` recovery paths keep working.
    """


def _flatten(tree: PyTree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index; a leaf is anything that is not a dict, list or
    tuple (None is an empty subtree, as in a jax pytree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (str(i),))
        return out
    return [(_SEP.join(prefix), tree)]


def _unflatten(tree: PyTree, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """A tree of ``tree``'s structure whose leaves come from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)(
            (k, _unflatten(tree[k], leaves, prefix + (str(k),))) for k in tree
        )
    if isinstance(tree, (list, tuple)):
        vals = [_unflatten(v, leaves, prefix + (str(i),)) for i, v in enumerate(tree)]
        return type(tree)(vals) if isinstance(tree, list) else tuple(vals)
    return leaves[_SEP.join(prefix)]


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 tensors as a uint16 view
    (returned with the dtype name to record)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
        return t.numpy().copy(), None
    arr = np.array(leaf)  # a copy: later mutation of the tree is safe
    return arr, None


def _bf16_tensor(arr: np.ndarray) -> torch.Tensor:
    # np.array, not np.ascontiguousarray: the latter makes 0-d arrays 1-d
    return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)


def _encode(step: int, host: List[Tuple[str, Tuple[np.ndarray, Optional[str]]]]):
    """(arrays.npz bytes, manifest.json text) of the host leaves: the
    bytes ``np.savez`` writes to a file, and each array's dtype, shape and
    CRC32."""
    manifest = {"step": step, "arrays": {}}
    for key, (arr, dtype) in host:
        manifest["arrays"][key] = {
            "dtype": dtype or str(arr.dtype),
            "shape": list(arr.shape),
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        }
    buf = io.BytesIO()
    np.savez(buf, **{key: arr for key, (arr, _) in host})
    return buf.getvalue(), json.dumps(manifest)


class CheckpointManager:
    def __init__(self, directory, keep_last_k: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep_last_k
        self._thread: Optional[threading.Thread] = None
        # a crash mid-save leaves step_<n>.tmp/ behind; it never shadows a
        # finished checkpoint (the rename is the commit point) but it leaks
        # disk on every restart of a preempted job -- sweep it here
        for p in self.dir.glob("step_*.tmp"):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: PyTree, *, async_: bool = False) -> None:
        payload = _encode(step, [(k, _to_host(leaf)) for k, leaf in _flatten(tree)])
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, *payload), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, *payload)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, npz: bytes, manifest: str) -> None:
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        (tmp / "arrays.npz").write_bytes(npz)
        (tmp / "manifest.json").write_text(manifest)
        with open(tmp / "manifest.json") as f:
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
                out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_step(self, step: int):
        """Manifest + npz handle for a step, with corruption surfaced."""
        d = self.dir / f"step_{step:010d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            arrays_meta = manifest["arrays"]
        except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
            raise CheckpointCorruptError(
                f"manifest.json at step {step} in {self.dir} is missing or "
                f"truncated ({type(e).__name__}: {e})"
            ) from e
        try:
            data = np.load(d / "arrays.npz")
        except Exception as e:
            raise CheckpointCorruptError(
                f"arrays.npz at step {step} in {self.dir} is unreadable "
                f"({type(e).__name__}: {e})"
            ) from e
        return arrays_meta, data

    def _read_array(self, arrays_meta, data, key: str, step: int, verify: bool):
        """The stored array of ``key`` (bfloat16 as a torch tensor)."""
        meta = arrays_meta.get(key)
        if meta is None:
            raise CheckpointCorruptError(
                f"array '{key}' missing from manifest at step {step} "
                f"in {self.dir}"
            )
        try:
            arr = data[key]
        except Exception as e:
            raise CheckpointCorruptError(
                f"array '{key}' unreadable in arrays.npz at step {step} "
                f"in {self.dir} ({type(e).__name__}: {e})"
            ) from e
        if verify:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != meta["crc32"]:
                raise CheckpointCorruptError(
                    f"checksum mismatch for array '{key}' at step {step} "
                    f"in {self.dir}"
                )
        if meta["dtype"] == "bfloat16":
            return _bf16_tensor(arr)
        return arr

    def restore_flat(
        self, *, step: Optional[int] = None, verify: bool = True
    ) -> dict:
        """Restore every saved array as a flat {key: np.ndarray} dict
        (a bfloat16 array comes back as a CPU bfloat16 tensor).

        For consumers whose tree structure is data-dependent (a resumable
        sweep's per-spec result records): the saved keys ARE the structure,
        so no abstract tree is required.  Integrity checks match restore().
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        arrays_meta, data = self._load_step(step)
        return {
            key: self._read_array(arrays_meta, data, key, step, verify)
            for key in arrays_meta
        }

    def restore(
        self,
        abstract_tree: PyTree,
        *,
        step: Optional[int] = None,
        device=None,
        verify: bool = True,
    ) -> PyTree:
        """Restore into the structure of ``abstract_tree``.

        A tensor leaf of the abstract tree comes back as a tensor on its
        device (or on ``device=`` when given); any other leaf comes back as
        a numpy array, unless ``device=`` is given, which makes it a tensor
        there too.  bfloat16 arrays always come back as tensors.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        arrays_meta, data = self._load_step(step)
        leaves = {}
        for key, leaf in _flatten(abstract_tree):
            arr = self._read_array(arrays_meta, data, key, step, verify)
            dev = device
            if dev is None and isinstance(leaf, torch.Tensor):
                dev = leaf.device
            if dev is not None:
                arr = (arr if isinstance(arr, torch.Tensor)
                       else torch.from_numpy(np.array(arr))).to(dev)
            leaves[key] = arr
        return _unflatten(abstract_tree, leaves)
