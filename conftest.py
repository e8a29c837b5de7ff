"""Fixtures shared by every test directory of the repo."""

import sys

import pytest


@pytest.fixture(autouse=True)
def _port_tracing_restored():
    """Leave the port's tracing switch as the test found it: loading a
    benchmark reader switches it on (``splaybench/program_trace.py``),
    and a later test in the same process would run traced."""
    trace = sys.modules.get("repro_torch.core.trace")
    was = trace.enabled() if trace is not None else False
    yield
    trace = sys.modules.get("repro_torch.core.trace")
    if trace is not None:
        trace.enable(was)
