"""State and parameters across the two packages, through numpy.

A state travels as a plain dict of numpy arrays holding the JAX
``CellState`` fields::

    {"arrays": {name: array}, "alive": (C,) bool,
     "partners": (C, K) int32, "bond_mask": (C, K) bool,
     "gradients": {name: (nx, ny) float32},
     "key": (2,) uint32, "step": int32 scalar, "next_id": int32 scalar}

``numpy_from_jax_state`` reads that dict off a JAX ``CellState`` by
attribute access and ``np.asarray`` alone, so this module never imports
JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hipsc_abm_tpu_torch import params as params_mod
from hipsc_abm_tpu_torch.engine import CellState
from hipsc_abm_tpu_torch.ops.jkr import BondState


def numpy_from_jax_state(jstate) -> dict:
    """The numpy dict of a JAX ``CellState``."""
    return {
        "arrays": {k: np.asarray(v) for k, v in jstate.arrays.items()},
        "alive": np.asarray(jstate.alive),
        "partners": np.asarray(jstate.bonds.partners),
        "bond_mask": np.asarray(jstate.bonds.mask),
        "gradients": {k: np.asarray(v) for k, v in jstate.gradients.items()},
        "key": np.asarray(jstate.key).astype(np.uint32),
        "step": np.int32(np.asarray(jstate.step)),
        "next_id": np.int32(np.asarray(jstate.next_id)),
    }


def state_from_numpy(d: dict, device="cuda") -> CellState:
    """A port ``CellState`` on ``device`` (the card unless the caller asks
    for the CPU, as ``HipscEngine`` does) from the numpy dict."""
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return CellState(
        arrays={k: t(v) for k, v in d["arrays"].items()},
        alive=t(np.asarray(d["alive"], dtype=bool)),
        bonds=BondState(partners=t(np.asarray(d["partners"], dtype=np.int32)),
                        mask=t(np.asarray(d["bond_mask"], dtype=bool))),
        gradients={k: t(v) for k, v in d["gradients"].items()},
        key=torch.from_numpy(np.asarray(d["key"], dtype=np.uint32).astype(np.int64)),
        step=int(d["step"]),
        next_id=torch.tensor(int(d["next_id"]), dtype=torch.int32, device=dev),
    )


def state_to_numpy(state: CellState) -> dict:
    """The numpy dict of a port ``CellState``: copies, which share no memory
    with the state's tensors (on the CPU too)."""

    def n(x):
        return x.detach().to("cpu", copy=True).numpy()

    return {
        "arrays": {k: n(v) for k, v in state.arrays.items()},
        "alive": n(state.alive),
        "partners": n(state.bonds.partners),
        "bond_mask": n(state.bonds.mask),
        "gradients": {k: n(v) for k, v in state.gradients.items()},
        "key": n(state.key).astype(np.uint32),
        "step": np.int32(state.step),
        "next_id": np.int32(int(state.next_id)),
    }


def params_from_jax(obj):
    """The port's parameter dataclass of the same name and field values as a
    JAX package parameter object (``GeneralParams``, ``ExperimentalParams``,
    ``BiologyParams`` or ``DiffusionParams``)."""
    cls = getattr(params_mod, type(obj).__name__)
    return cls(**dataclasses.asdict(obj))
