"""State checkpoints in the JAX package's npz layout (port of
``hipsc_abm_tpu/utils/checkpoint.py``).

Format v2, one npz per checkpoint: ``arrays/<name>`` per agent array,
``alive``, ``bonds/partners``, ``bonds/mask``, ``gradients/<name>``, ``key``
(the threefry key as the JAX uint32 pair), ``step`` and ``next_id`` (int32
scalars) and ``meta`` (JSON as uint8 bytes). A checkpoint either package
writes loads in the other; the port holds the key as ``(2,)`` int64 words in
memory. The key is part of the state, so a resume is bit-exact.

The domain engine's sharded checkpoint (``save_domain_sharded``) is a
directory: ``shard_{s}.npz`` per tile with that tile's slot block (the same
per-agent names), the replicated leaves (``gradients/<name>``, ``key``,
``step``, ``next_id``) in ``shard_0.npz``, and ``manifest.json`` with
``format_version``, ``n_shards`` and the metadata. Each process writes only
its own tiles; either package's directory loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple, Union

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


def _write_npz(path: str, payload: dict) -> None:
    """``payload`` as a compressed npz at ``path``, published atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)


def save_domain_sharded(path: str, tiles: Dict[int, dict], n_shards: int,
                        shared: Optional[dict] = None, meta: dict | None = None,
                        rank: int = 0, barrier: Optional[Callable[[], None]] = None) -> None:
    """Write the tiles this process holds as ``path/shard_{s}.npz``.

    ``tiles`` maps a tile index to its host slot block (``{"arrays",
    "alive", "partners", "bond_mask"}``, numpy); ``shared`` holds the
    replicated leaves (``{"gradients", "key", "step", "next_id"}``) and rides
    shard 0, so the process that holds tile 0 passes it. After every
    process's shards are written (``barrier``, when the tiles are spread
    over processes), rank 0 publishes ``manifest.json``; the second barrier
    makes a returned save a loadable one on every rank."""
    os.makedirs(path, exist_ok=True)
    for s, host in sorted(tiles.items()):
        payload = {f"arrays/{k}": np.asarray(v) for k, v in host["arrays"].items()}
        payload["alive"] = np.asarray(host["alive"])
        payload["bonds/partners"] = np.asarray(host["partners"])
        payload["bonds/mask"] = np.asarray(host["bond_mask"])
        if s == 0:
            if shared is None:
                raise ValueError("shard 0 carries the replicated leaves: pass shared")
            payload.update({f"gradients/{k}": np.asarray(v)
                            for k, v in shared["gradients"].items()})
            payload["key"] = np.asarray(shared["key"], dtype=np.uint32)
            payload["step"] = np.asarray(shared["step"], dtype=np.int32)
            payload["next_id"] = np.asarray(shared["next_id"], dtype=np.int32)
        _write_npz(os.path.join(path, f"shard_{s}.npz"), payload)
    if barrier is not None:
        # the manifest must imply that every shard is complete
        barrier()
    if rank == 0:
        manifest = {"format_version": _FORMAT_VERSION, "n_shards": int(n_shards), **(meta or {})}
        tmp = os.path.join(path, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, "manifest.json"))
    if barrier is not None:
        barrier()


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_domain_tiles(path: str, tiles) -> Tuple[Dict[int, dict], dict, dict]:
    """The slot blocks of ``tiles`` as saved (``{s: {"arrays", "alive",
    "partners", "bond_mask"}}``, numpy), the replicated leaves from shard 0
    and the manifest: what a resume onto the same tile grid places back
    as it was, reading only its own shards and shard 0."""
    meta = read_manifest(path)
    blocks, shared = {}, {}
    for s in sorted(set(tiles) | {0}):
        with np.load(os.path.join(path, f"shard_{s}.npz")) as data:
            if s == 0:
                shared = {"gradients": {k.split("/", 1)[1]: data[k] for k in data.files
                                        if k.startswith("gradients/")},
                          "key": data["key"], "step": data["step"], "next_id": data["next_id"]}
            if s in tiles:
                blocks[s] = {"arrays": {k.split("/", 1)[1]: data[k] for k in data.files
                                        if k.startswith("arrays/")},
                             "alive": data["alive"], "partners": data["bonds/partners"],
                             "bond_mask": data["bonds/mask"]}
    return blocks, shared, meta


def load_domain_sharded(path: str, device="cuda") -> Tuple[CellState, dict]:
    """Reassemble a sharded domain checkpoint (either package's) into a flat
    ``CellState`` on ``device``, tiles in order (the caller re-partitions
    it), and the manifest's metadata."""
    meta = read_manifest(path)
    parts: dict = {"arrays": {}, "alive": [], "partners": [], "bond_mask": []}
    host: dict = {"gradients": {}}
    for s in range(int(meta["n_shards"])):
        with np.load(os.path.join(path, f"shard_{s}.npz")) as data:
            for k in data.files:
                if k.startswith("arrays/"):
                    parts["arrays"].setdefault(k.split("/", 1)[1], []).append(data[k])
                elif k.startswith("gradients/"):
                    host["gradients"][k.split("/", 1)[1]] = data[k]
            parts["alive"].append(data["alive"])
            parts["partners"].append(data["bonds/partners"])
            parts["bond_mask"].append(data["bonds/mask"])
            if s == 0:
                host.update(key=data["key"], step=data["step"], next_id=data["next_id"])
    host["arrays"] = {k: np.concatenate(v, axis=0) for k, v in parts["arrays"].items()}
    for k in ("alive", "partners", "bond_mask"):
        host[k] = np.concatenate(parts[k], axis=0)
    return convert.state_from_numpy(host, device), meta
