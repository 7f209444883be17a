"""State checkpoints in the JAX package's npz layout (port of
``hipsc_abm_tpu/utils/checkpoint.py``'s ``save_state`` / ``load_state``).

Format v2, one npz per checkpoint: ``arrays/<name>`` per agent array,
``alive``, ``bonds/partners``, ``bonds/mask``, ``gradients/<name>``, ``key``
(the threefry key as the JAX uint32 pair), ``step`` and ``next_id`` (int32
scalars) and ``meta`` (JSON as uint8 bytes). A checkpoint either package
writes loads in the other; the port holds the key as ``(2,)`` int64 words in
memory. The key is part of the state, so a resume is bit-exact.
"""

from __future__ import annotations

import json
import os
from typing import Tuple, Union

import numpy as np

from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import CellState

_FORMAT_VERSION = 2  # v2: + arrays/ids, next_id (stable agent identity)


def save_state(path: str, state: Union[CellState, dict], meta: dict | None = None) -> None:
    """Write a state (a ``CellState`` or its ``convert.state_to_numpy``
    dict) to ``path`` atomically."""
    host = convert.state_to_numpy(state) if isinstance(state, CellState) else state
    payload = {f"arrays/{k}": np.asarray(v) for k, v in host["arrays"].items()}
    payload["alive"] = np.asarray(host["alive"])
    payload["bonds/partners"] = np.asarray(host["partners"])
    payload["bonds/mask"] = np.asarray(host["bond_mask"])
    payload.update({f"gradients/{k}": np.asarray(v) for k, v in host["gradients"].items()})
    payload["key"] = np.asarray(host["key"], dtype=np.uint32)
    payload["step"] = np.asarray(host["step"], dtype=np.int32)
    payload["next_id"] = np.asarray(host["next_id"], dtype=np.int32)
    payload["meta"] = np.frombuffer(
        json.dumps({"format_version": _FORMAT_VERSION, **(meta or {})}).encode(),
        dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)


def load_state(path: str, device="cuda") -> Tuple[CellState, dict]:
    """``(CellState on device, meta)`` from an npz checkpoint."""
    with np.load(path) as data:
        files = data.files
        host = {
            "arrays": {k.split("/", 1)[1]: data[k] for k in files if k.startswith("arrays/")},
            "alive": data["alive"],
            "partners": data["bonds/partners"],
            "bond_mask": data["bonds/mask"],
            "gradients": {k.split("/", 1)[1]: data[k] for k in files
                          if k.startswith("gradients/")},
            "key": data["key"],
            "step": data["step"],
            "next_id": data["next_id"],
        }
        meta = json.loads(bytes(data["meta"]).decode()) if "meta" in files else {}
    return convert.state_from_numpy(host, device), meta
