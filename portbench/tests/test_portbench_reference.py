"""The benchmark's plain reference (``portbench.reference``) against the
port's step, bit for bit by agent id, on small seeded colonies of each
configuration and variant; its imports; and the lower-precision control,
which the comparison has to refuse.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from portbench import catalog, check
from portbench.colony import colony
from portbench.tests.conftest import SPHEROID, SPHEROID_TRAFFIC, small_traffic

entries = catalog.load_module("entries", "engine_blocks")


def _config_and_traffic(case):
    config, variant, path = case
    if config == "spheroid3d":
        return SPHEROID, dict(SPHEROID_TRAFFIC, variant=variant, contact_path=path)
    return (catalog.load_json("configs", config),
            dict(small_traffic("uniform_500k_idlist_k5"), variant=variant, contact_path=path))


# (configuration, variant, contact path of the port): the benchmark's
# configuration, the 3D spheroid on both laws, and the span-mask path,
# which the id-list reference stands for
CASES = [
    ("hipsc2d", "uniform", "id_list"),
    ("spheroid3d", "uniform", "span_mask"),
    ("spheroid3d", "uniform", "id_list"),
    ("spheroid3d", "general", "id_list"),
]
SEED = 2**31 + 77


def port_states(case, seed: int, device: str, steps: int):
    """The port's colony before and after ``CHECK_STEPS`` steps that start
    after ``steps`` steps from the seeded colony, as flat numpy states."""
    config, traffic = _config_and_traffic(case)
    col = colony(config, traffic, seed)
    entry = entries.Entry(col, traffic, seed, device)
    state = entries.initial_state(entry.eng, col, seed)
    states = [check.flat_numpy(state)]
    for _ in range(steps + check.CHECK_STEPS):
        state, _ = entry.eng.safe_step(state)
        states.append(check.flat_numpy(state))
    return states[steps], states[-1], col


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_reference_equals_port_plain_step(case):
    _, out, col = port_states(case, SEED, "cpu", 0)
    ref, _ = check.reference_output(col, check.Case(SEED, None, 1, out), "cpu")
    numbers = check.compare(out, ref)
    assert numbers == {k: 0 for k in numbers}, numbers


@pytest.mark.parametrize("case", CASES[:1] + CASES[3:], ids="-".join)
def test_reference_from_the_port_state_equals_the_port(case):
    """The last stretch's comparison: the reference run from the port's own
    state after 3 steps, with the step keys it works out from the seed."""
    start, out, col = port_states(case, SEED, "cpu", 3)
    ref, caps = check.reference_output(col, check.Case(SEED, start, 4, out), "cpu")
    numbers = check.compare(out, ref)
    assert numbers == {k: 0 for k in numbers}, numbers
    assert caps["live_most"] >= int(start["alive"].sum())


def test_reference_loads_no_port_and_no_jax():
    code = ("import sys; import portbench.reference.step, portbench.check; "
            "bad = sorted({m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'hipsc_abm_tpu', 'hipsc_abm_tpu_torch')}); "
            "print(bad); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


@pytest.mark.parametrize("case", CASES[:1] + CASES[3:], ids="-".join)
def test_lower_precision_control_is_refused(case):
    """The reference with its positions held in bfloat16 in the program's
    place: the comparison finds it apart."""
    config, traffic = _config_and_traffic(case)
    col = colony(config, traffic, SEED)
    first = check.Case(SEED, None, 1, {})
    exact, _ = check.reference_output(col, first, "cpu")
    control, _ = check.reference_output(col, first, "cpu", stored=torch.bfloat16)
    numbers = check.compare(control, exact)
    assert not check.is_correct(dict(numbers, calls_unlike_first=0)), numbers
    assert numbers["fields_apart"] > 0 and numbers["position_gap_um"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_reference_on_card_equals_port_on_card(card, case):
    _, out, col = port_states(case, SEED, card, 0)
    ref, _ = check.reference_output(col, check.Case(SEED, None, 1, out), card)
    numbers = check.compare(out, ref)
    assert numbers == {k: 0 for k in numbers}, numbers
