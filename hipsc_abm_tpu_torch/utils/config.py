"""YAML templates (port of ``hipsc_abm_tpu/utils/config.py``).

``template_params`` reads ``templates/*.yaml`` with ``yaml.safe_load`` when
PyYAML is installed, and otherwise with ``read_simple_yaml``, a reader of the
subset the reference templates use: ``key: scalar`` and ``key: [a, b, c]``
lines and ``#`` comments, scalars resolved as PyYAML resolves them (bool,
int, float, null, else string). ``yaml`` is imported lazily, so this module
imports without it.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Optional

_BOOLS = {v: True for v in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")}
_BOOLS.update({v: False for v in ("false", "False", "FALSE", "no", "No", "NO", "off", "Off",
                                  "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")
# PyYAML's decimal int and float resolvers (YAML 1.1: a float needs a dot)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOATS = {".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"),
                   ".nan": float("nan")}


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if text.lower() in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text.lower()]
    return text


def read_simple_yaml(text: str) -> dict:
    """Parse the template subset of YAML: one ``key: value`` per line, where
    value is a scalar or a flow list ``[a, b, c]``."""
    out = {}
    for number, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        key, sep, value = line.partition(":")
        if not sep or raw[:1].isspace():
            raise ValueError(f"line {number}: not a 'key: value' line: {raw!r}")
        value = value.strip()
        if value.startswith("["):
            if not value.endswith("]"):
                raise ValueError(f"line {number}: unterminated list: {raw!r}")
            inner = value[1:-1].strip()
            out[key.strip()] = [_scalar(v) for v in inner.split(",")] if inner else []
        else:
            out[key.strip()] = _scalar(value)
    return out


def _load(path: str) -> dict:
    with open(path, "r") as file:
        text = file.read()
    try:
        import yaml
    except ImportError:
        return read_simple_yaml(text)
    return yaml.safe_load(text)


def template_params(path: str) -> dict:
    """Parameters dict from a YAML template file."""
    return _load(path)


def _dump(keys: dict, path: str) -> None:
    try:
        import yaml
    except ImportError:
        with open(path, "w") as file:
            file.writelines(f"{k}: {v}\n" for k, v in keys.items())
        return
    with open(path, "w") as file:
        yaml.dump(keys, file)


def check_output_dir(paths_file: str = "paths.yaml",
                     interactive: Optional[bool] = None) -> str:
    """Read the output root from ``paths.yaml`` and make sure it exists. In
    non-interactive mode (the default when stdin is not a TTY) a missing
    directory is created instead of prompting."""
    keys = _load(paths_file)
    output_dir = keys["output_dir"]
    if interactive is None:
        interactive = sys.stdin.isatty()

    while not os.path.isdir(output_dir):
        if not interactive:
            os.makedirs(output_dir, exist_ok=True)
            break
        print(f'\nSimulation output directory: "{output_dir}" does not exist!')
        user = input('Do you want to make this directory? If "n", you can specify'
                     " the correct path (y/n): ")
        print()
        if user == "y":
            os.makedirs(output_dir)
            break
        elif user == "n":
            output_dir = input("Correct path (absolute) to output directory: ")
            keys["output_dir"] = output_dir
            _dump(keys, paths_file)
        else:
            print('Either type "y" or "n"')

    if output_dir[-1] != os.path.sep:
        output_dir += os.path.sep
    return output_dir


def check_direct(path: str) -> None:
    """Make sure a directory exists."""
    if not os.path.isdir(path):
        os.makedirs(path, exist_ok=True)
