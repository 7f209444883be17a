"""The readers of the program's own tracing (``portbench/spans.py``) on a
small CPU cell of each entry through ``run_cell(device="cpu")``: the device
metrics give nothing there, the rebuild counter a number, and a program
without the tracing nothing at all.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import pytest

from portbench import catalog, run

SEED = 2**31 + 7
DEVICE_METRICS = ("step.sort_ms", "step.biology_ms", "step.diffusion_ms", "step.window_ms",
                  "step.contact_ms", "step.finish_ms", "replay.device_ms_per_call",
                  "host.ms_per_call", "graph.nodes_per_step")


@pytest.mark.parametrize("cell", ["c2d_500k_idlist_k5", "c2d_ens16x5k"])
def test_span_readers_on_a_cpu_cell(small_root, cell):
    result = run.run_cell(cell, SEED, 0.1, True, device="cpu", root=small_root,
                          log=lambda m: None)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    listed = {name for name, _ in catalog.metrics_of(cell, "per_layer", small_root)}
    assert set(DEVICE_METRICS) & listed
    for name in DEVICE_METRICS:
        assert name not in metrics
    if "contact.rebuilds_per_step" in listed:
        rebuilds = metrics["contact.rebuilds_per_step"]
        assert rebuilds["unit"] == "count" and 0 <= rebuilds["value"] <= 10


def test_span_readers_give_nothing_without_the_tracing(small_root, monkeypatch):
    from hipsc_abm_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracing")
    result = run.run_cell("c2d_500k_idlist_k5", SEED, 0.1, True, device="cpu",
                          root=small_root, log=lambda m: None)
    assert result["correct"]
    assert "contact.rebuilds_per_step" not in result["metrics"]
