"""Each cell's whole run on the card, at full size, for one short window:
``python3 -m pytest bench_port/tests -m card`` on a machine with a CUDA
card (elsewhere these skip)."""

from __future__ import annotations

import pytest

from bench_port import run
from bench_port.registry import Registry

CELLS = [w["name"] for w in Registry().bench["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(card, cell):
    result, checks = run.run_cell(Registry(), cell, 2**31 + 99, 1.0, False, card)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
