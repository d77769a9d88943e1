"""With the timed path broken underneath, a run's ``correct`` comes out
false: for each fault a cell can have on one chip (there is no exchange
between chips to leave out).  The harness's look for a chip is skipped by
calling ``run_cell`` on the CPU."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from bench_port import program_api, run
from bench_port.registry import Registry

import bikg_graph_explainability_public_tpu_torch.explain.batch as batch
import bikg_graph_explainability_public_tpu_torch.explain.explainer as explainer
import bikg_graph_explainability_public_tpu_torch.explain.wlm as wlm

REG = Registry()
CELLS = {w["name"]: REG.traffic(w["traffic"])["entry"] for w in REG.bench["workloads"]}


def _half_rows(weights):
    """Kernel weights with the second half of each query's rows left out of
    the weighted mean."""
    out = weights.clone()
    out[..., out.shape[-1] // 2 :] = 0.0
    return out


def _altered(scores):
    """An answer altered where it is made: every score 1 % off."""
    return np.asarray(scores) * 1.01


def _patch(monkeypatch, module, name: str, make) -> None:
    """``module.name`` replaced by ``make(original)``, keeping the
    original's signature for :func:`program_api.check`."""
    original = getattr(module, name)
    monkeypatch.setattr(module, name, functools.wraps(original)(make(original)))


def _break(monkeypatch, entry: str, fault: str) -> None:
    program_api.check()  # the positions and keywords broken below
    if entry == "explain_many":
        if fault == "state_unchanged":
            _patch(monkeypatch, batch, "_train",
                   lambda train: lambda *a: train(*a[:8], 0.0, *a[9:]))
        elif fault == "half_batch":
            _patch(monkeypatch, batch, "_kernel_weights",
                   lambda kw: lambda m, n: _half_rows(kw(m, n)))
        else:
            _patch(monkeypatch, batch, "_assemble",
                   lambda assemble: lambda fetched, entry_: [
                       ex._replace(mean=_altered(ex.mean)) for ex in assemble(fetched, entry_)])
    else:
        if fault == "state_unchanged":
            _patch(monkeypatch, wlm, "train_surrogate",
                   lambda surrogate: lambda *a, **k: surrogate(*a, **dict(k, lr=0.0)))
        elif fault == "half_batch":
            _patch(monkeypatch, wlm, "shap_kernel",
                   lambda kernel: lambda m, **k: _half_rows(kernel(m, **k)))
        else:
            def altering(stacking):
                def altered(weights):
                    mean, std = stacking(weights)
                    return _altered(mean), std
                return altered
            _patch(monkeypatch, explainer, "weight_stacking", altering)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_path_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    _break(monkeypatch, CELLS[cell], fault)
    result, checks = run.run_cell(tiny_bench, cell, 2**31 + 21, 0.0, False, "cpu")
    assert not result["correct"], checks
    assert result["failed"] == 0


def test_the_pinned_program_functions_hold(monkeypatch):
    program_api.check()
    monkeypatch.setattr(batch, "_train", lambda masks, outputs: None)
    with pytest.raises(RuntimeError, match="_train"):
        program_api.check()
