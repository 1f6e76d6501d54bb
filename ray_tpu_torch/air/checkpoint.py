"""Checkpoint: a value object morphing dict <-> directory <-> bytes.

Reference: ``python/ray/air/checkpoint.py:63`` — the same free-morphing
contract (a Checkpoint created from any form can be consumed in any form):
array leaves are numpy arrays or torch tensors, saved with
``np.savez`` and a pickled skeleton.  A tensor comes back as a CPU tensor
of its own dtype; bfloat16, which numpy lacks, is saved as its 16-bit
pattern and tagged, so it round-trips bit-exactly.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Dict, Optional

import numpy as np

_ARRAYS = "__arrays__.npz"
_PAYLOAD = "__payload__.pkl"
_META = "__meta__.json"


def _split_arrays(obj: Any, prefix: str, arrays: Dict[str, np.ndarray]):
    """Replace array leaves with placeholders, collecting them flat."""
    if isinstance(obj, dict):
        return {k: _split_arrays(v, f"{prefix}/{k}", arrays)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [_split_arrays(v, f"{prefix}/{i}", arrays)
                for i, v in enumerate(obj)]
        return type(obj)(vals) if not isinstance(obj, tuple) else tuple(vals)
    # A tree can hold a tensor only once torch is imported: never import
    # it here.
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arrays[prefix] = t.numpy()
        return {"__tensor_ref__": prefix, "dtype": dtype}
    if isinstance(obj, np.ndarray):
        arrays[prefix] = obj
        return {"__array_ref__": prefix}
    return obj


def _join_arrays(obj: Any, arrays) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {"__array_ref__"}:
            return arrays[obj["__array_ref__"]]
        if set(obj) == {"__tensor_ref__", "dtype"}:
            import torch

            t = torch.from_numpy(np.array(arrays[obj["__tensor_ref__"]]))
            return (t.view(torch.bfloat16) if obj["dtype"] == "bfloat16"
                    else t)
        return {k: _join_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [_join_arrays(v, arrays) for v in obj]
        return tuple(vals) if isinstance(obj, tuple) else vals
    return obj


class Checkpoint:
    """Morphing checkpoint (dict | directory | bytes)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 path: Optional[str] = None):
        if (data is None) == (path is None):
            raise ValueError("exactly one of data/path required")
        self._data = data
        self._path = path

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=path)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        return cls(data=pickle.loads(blob))

    # -- consumers ---------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return self._data
        arrays = {}
        npz_path = os.path.join(self._path, _ARRAYS)
        if os.path.exists(npz_path):
            with np.load(npz_path, allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        with open(os.path.join(self._path, _PAYLOAD), "rb") as f:
            skeleton = pickle.load(f)
        return _join_arrays(skeleton, arrays)

    def to_directory(self, path: Optional[str] = None) -> str:
        if self._path is not None and path is None:
            return self._path
        path = path or tempfile.mkdtemp(prefix="rtpu-ckpt-")
        os.makedirs(path, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(self._path) != os.path.abspath(path):
                shutil.copytree(self._path, path, dirs_exist_ok=True)
            return path
        arrays: Dict[str, np.ndarray] = {}
        skeleton = _split_arrays(self._data, "", arrays)
        if arrays:
            np.savez(os.path.join(path, _ARRAYS), **arrays)
        with open(os.path.join(path, _PAYLOAD), "wb") as f:
            pickle.dump(skeleton, f)
        with open(os.path.join(path, _META), "w") as f:
            json.dump({"format": "ray_tpu_torch.air.Checkpoint", "version": 1}, f)
        return path

    def to_bytes(self) -> bytes:
        return pickle.dumps(self.to_dict())

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._path}"
        return f"Checkpoint({kind})"
