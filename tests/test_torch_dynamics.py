"""PyTorch port: the multi-step dynamics against the JAX engine.

The bench-like colony at reference density (300 + 30 GATA6-high cells,
dox at step 5, FGF4 secretion and diffusion on) stepped 20 times with
``safe_step`` by both engines from the same seed, on each contact path of
the port. Per step the population must agree within 3% and the
differentiated and GATA6-high fractions within 0.02, in the spirit of
``tools/compare_dynamics.py``. The first step at which any agent's integer
state differs is printed, not asserted: float32 sums taken in another order
may move a cell across a bin or a contact boundary eventually, after which
the two colonies are different samples of the same dynamics.

The same trajectory also runs with the three optional phases on (growth,
stochastic GATA6 bumps, diff_surround) from radii drawn uniform in
[min_radius, max_radius], where the contact kernels take their general
pair law, under the same bounds.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hipsc_abm_tpu.engine import HipscEngine as JaxEngine
from hipsc_abm_tpu.models.params import (
    BiologyParams, DiffusionParams, ExperimentalParams, GeneralParams)
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import HipscEngine

N_CELLS = 300
STEPS = 20
SEED = 1
FLAGS = dict(enable_growth=True, enable_stochastic=True, enable_diff_surround=True)
INT_FIELDS = ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters")


def _params():
    side = 2000.0 * (N_CELLS / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=N_CELLS, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=N_CELLS // 10, dox_step=5)
    diff = DiffusionParams(spat_res=20.0, release_amount=0.01)
    return gen, xp, diff


def _summary(d: dict) -> dict:
    alive = d["alive"]
    order = np.argsort(d["arrays"]["ids"][alive])
    by_id = {k: d["arrays"][k][alive][order] for k in ("ids",) + INT_FIELDS}
    n = int(alive.sum())
    return dict(n=n, by_id=by_id,
                diff=float((by_id["states"] == 1).sum()) / n,
                gata6=float((by_id["GATA6"] > by_id["NANOG"]).sum()) / n)


def _seeded_radii(capacity: int) -> np.ndarray:
    bio = BiologyParams()
    rs = np.random.default_rng(SEED)
    return rs.uniform(bio.min_radius, bio.max_radius, capacity).astype(np.float32)


def _jax_run(**flags):
    gen, xp, diff = _params()
    eng = JaxEngine(gen, xp, diff=diff, enable_diffusion=True, **flags)
    state = eng.init_state(seed=SEED)
    if flags:
        radii = jnp.asarray(_seeded_radii(state.alive.shape[0]))
        state = state._replace(arrays={**state.arrays, "radii": radii})
    out = []
    for _ in range(STEPS):
        state, _ = eng.safe_step(state)
        out.append(_summary(convert.numpy_from_jax_state(state)))
    return out


@pytest.fixture(scope="module")
def jax_trajectory():
    return _jax_run()


@pytest.fixture(scope="module")
def jax_trajectory_flagged():
    return _jax_run(**FLAGS)


@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_trajectory_matches_jax(contact_path, jax_trajectory):
    _check_trajectory(contact_path, jax_trajectory)


@pytest.mark.parametrize("contact_path", ["id_list", "span_mask"])
def test_trajectory_with_optional_phases_matches_jax(contact_path, jax_trajectory_flagged):
    _check_trajectory(contact_path, jax_trajectory_flagged, **FLAGS)


def _check_trajectory(contact_path, jax_trajectory, **flags):
    gen, xp, diff = _params()
    eng = HipscEngine(*(convert.params_from_jax(p) for p in (gen, xp)),
                      diff=convert.params_from_jax(diff), enable_diffusion=True,
                      device="cpu", contact_path=contact_path, **flags)
    state = eng.init_state(seed=SEED)
    if flags:
        assert eng.cfg.uniform_radius is None
        radii = torch.from_numpy(_seeded_radii(state.capacity))
        state = state._replace(arrays={**state.arrays, "radii": radii})
    label = f"{contact_path}{', optional phases' if flags else ''}"
    first_int_diff = None
    lines = []
    for step, ref in enumerate(jax_trajectory, start=1):
        state, _ = eng.safe_step(state)
        got = _summary(convert.state_to_numpy(state))
        same = (np.array_equal(got["by_id"]["ids"], ref["by_id"]["ids"])
                and all(np.array_equal(got["by_id"][k], ref["by_id"][k]) for k in INT_FIELDS))
        if not same and first_int_diff is None:
            first_int_diff = step
        lines.append(f"step {step}: agents {got['n']}/{ref['n']}, differentiated "
                     f"{got['diff']:.4f}/{ref['diff']:.4f}, GATA6-high "
                     f"{got['gata6']:.4f}/{ref['gata6']:.4f}")
        assert abs(got["n"] - ref["n"]) <= 0.03 * ref["n"], lines[-1]
        assert abs(got["diff"] - ref["diff"]) <= 0.02, lines[-1]
        assert abs(got["gata6"] - ref["gata6"]) <= 0.02, lines[-1]
    print(f"\n[{label}] port/JAX per step:\n" + "\n".join(lines))
    print(f"[{label}] first step with any integer state differing: "
          f"{first_int_diff if first_int_diff is not None else f'none in {STEPS}'}")
    assert jax_trajectory[-1]["diff"] > 0 or jax_trajectory[-1]["gata6"] > 0
