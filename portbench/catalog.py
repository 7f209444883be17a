"""Finding the benchmark's parts by name. A cell and its metrics are entries
of ``BENCHMARK.json`` (beside the benchmark's folder); every configuration,
traffic mix, entry, metric reader and count family is a file of its own
under the folder, so a new one is a new file and no existing file is
edited.

- ``BENCHMARK.json``: each cell's ``config`` and ``traffic``, each
  metric's unit and the cells it is reported in;
- ``configs/<name>.json``, ``traffic/<name>.json``: data (``colony``);
- ``entries/<name>.py``: the program's entry a traffic file names;
- ``metrics/<name>.py``: one metric's reader, ``read(run)``;
- ``counts/<family>.py``: one kernel family's bytes and operations.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import List, Optional, Tuple

ROOT = Path(__file__).resolve().parent


def bench(root: Optional[Path] = None) -> dict:
    """``BENCHMARK.json`` of the checkout that holds ``root``."""
    path = (root or ROOT).parent / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no benchmark file {path}")
    return json.loads(path.read_text())


def cell(name: str, root: Optional[Path] = None) -> dict:
    """The workload entry ``name`` of ``BENCHMARK.json``."""
    for w in bench(root)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(name: str, kind: str, root: Optional[Path] = None) -> List[Tuple[str, str]]:
    """``(metric, unit)`` of the ``kind`` metrics (``end_to_end`` or
    ``per_layer``) that cell ``name`` reports: those that list it under
    ``workloads``, or list no cells."""
    return [(m["name"], m["unit"]) for m in bench(root)[kind]
            if name in m.get("workloads", [name])]


def load_json(kind: str, name: str, root: Optional[Path] = None) -> dict:
    """``<root>/<kind>/<name>.json``; raises naming the file when it is
    missing."""
    path = (root or ROOT) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Optional[Path] = None) -> ModuleType:
    """The module of ``<root>/<kind>/<name>.py``, loaded from its path (a
    metric's name may hold dots), once per path."""
    path = ((root or ROOT) / kind / f"{name}.py").resolve()
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"portbench_{kind}_{abs(hash(str(path)))}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def names(kind: str, root: Optional[Path] = None) -> List[str]:
    """The names of the files of ``kind``, sorted."""
    folder = (root or ROOT) / kind
    suffix = ".py" if kind in ("entries", "metrics", "counts") else ".json"
    return sorted(p.name[:-len(suffix)] for p in folder.glob(f"*{suffix}")
                  if not p.name.startswith("_"))
