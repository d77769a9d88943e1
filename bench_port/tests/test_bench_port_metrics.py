"""Readers of single metrics on hand-made records."""

from __future__ import annotations

import pytest

from bench_port.registry import Registry

REG = Registry()


def test_p90_reads_only_the_requests_after_the_profiled_slice():
    p90 = REG.metric("explain_p90_ms.run")
    lat = [9.0, 9.0] + [0.1 * i for i in range(1, 11)]
    assert p90.read({"latencies_s": lat, "profile": {"calls": 2}}) == pytest.approx(910.0)
    assert p90.read({"latencies_s": lat[2:]}) == pytest.approx(910.0)


def test_p90_returns_nothing_where_the_slice_took_every_request():
    p90 = REG.metric("explain_p90_ms.run")
    assert p90.read({"latencies_s": [1.0, 2.0], "profile": {"calls": 2}}) is None
    assert p90.read({"latencies_s": []}) is None
