"""Command-line flags and text UI (port of ``hipsc_abm_tpu/utils/cli.py``).

The same flags (``-n`` name, ``-m`` mode, ``-fs`` final step), the same four
modes and the same overwrite/existence guards, with a non-interactive path
for headless runs (missing flags raise instead of prompting when stdin is
not a TTY). ``-d`` names the torch device of a run (``cuda`` unless given).
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Optional, Tuple


def commandline_param(flag: str, dtype, argv: Optional[list] = None):
    """Value for a command-line option (``backend.py:216-231``)."""
    args = sys.argv if argv is None else argv
    for i, arg in enumerate(args):
        if arg == flag:
            try:
                return dtype(args[i + 1])
            except IndexError:
                raise Exception(f"No value for option: {arg}")
    raise Exception(f"Option: {flag} not found")


def _interactive() -> bool:
    return sys.stdin.isatty()


def get_name_mode(argv: Optional[list] = None) -> Tuple[str, int]:
    """Simulation name and mode from flags or the text UI
    (``backend.py:283-318``)."""
    try:
        name = commandline_param("-n", str, argv)
    except Exception:
        if not _interactive():
            raise Exception("Missing -n <name> (non-interactive run)")
        while True:
            name = input('What is the "name" of the simulation? Type "help" for more information: ')
            if name == "help":
                print("\nType the name of the simulation (not a path).\n")
            else:
                break

    try:
        mode = commandline_param("-m", int, argv)
    except Exception:
        if not _interactive():
            raise Exception("Missing -m <mode> (non-interactive run)")
        while True:
            mode = input('What is the "mode" of the simulation? Type "help" for more information: ')
            if mode == "help":
                print("\nHere are the following modes:\n0: New simulation\n"
                      "1: Continuation of past simulation\n"
                      "2: Turn simulation images to video\n3: Zip previous simulation\n")
            else:
                try:
                    mode = int(mode)
                    print()
                    break
                except ValueError:
                    print('\nInput: "mode" should be an integer.\n')

    return name, mode


def get_final_step(argv: Optional[list] = None) -> int:
    """New final step for continuation mode (``backend.py:321-346``)."""
    try:
        return commandline_param("-fs", int, argv)
    except Exception:
        if not _interactive():
            raise Exception("Missing -fs <final step> (non-interactive run)")
        while True:
            final_step = input("What is the final step of this continued simulation?"
                               ' Type "help" for more information: ')
            if final_step == "help":
                print("\nEnter the new step number that will be the last step of the simulation.\n")
            else:
                try:
                    return int(final_step)
                except ValueError:
                    print('Input: "final step" should be an integer.\n')


def get_device(argv: Optional[list] = None) -> str:
    """The torch device of the run: the ``-d`` flag's value, else ``cuda``."""
    try:
        return commandline_param("-d", str, argv)
    except Exception:
        return "cuda"


def check_new_sim(name: str, output_path: str, overwrite: Optional[bool] = None) -> str:
    """Guard against silently overwriting a previous simulation
    (``backend.py:349-387``). ``overwrite=True`` clears without prompting."""
    while True:
        target = os.path.join(output_path, name)
        if os.path.isdir(target):
            if overwrite is None and not _interactive():
                raise Exception(f"Simulation already exists with name: {name}")
            if overwrite is None:
                print("Simulation already exists with name: " + name)
                user = input("Would you like to overwrite that simulation? (y/n): ")
                print()
            else:
                user = "y" if overwrite else "n"
            if user == "n":
                if not _interactive():
                    raise Exception(f"Simulation already exists with name: {name}")
                name = input("New name: ")
                print()
            elif user == "y":
                for file in os.listdir(target):
                    path = os.path.join(target, file)
                    if os.path.isfile(path):
                        os.remove(path)
                    else:
                        shutil.rmtree(path)
                break
            else:
                print('Either type "y" or "n"')
        else:
            os.makedirs(target)
            break
    return name


def check_previous_sim(name: str, output_path: str) -> str:
    """Make sure a previous simulation exists (``backend.py:390-404``)."""
    while True:
        if os.path.isdir(os.path.join(output_path, name)):
            break
        if not _interactive():
            raise Exception(f"No directory exists with name/path: {output_path}{name}")
        print("No directory exists with name/path: " + output_path + name)
        name = input('\nPlease type the correct name of the simulation or type "exit" to exit: ')
        print()
        if name == "exit":
            raise SystemExit
    return name


def progress_bar(progress: int, maximum: int, length: int = 60) -> None:
    """Text progress bar (``backend.py:170-183``)."""
    progress += 1
    fill = int(length * progress / maximum)
    bar = "#" * fill + "." * (length - fill)
    percent = int(100 * progress / maximum)
    print(f"\r[{bar}] {percent}%", end="")
