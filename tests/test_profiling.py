"""utils/profiling: stage timer and trace annotations."""

import pytest

from kss_icp.utils.profiling import StageTimer, trace_annotation


def test_trace_annotation_runs_body():
    ran = []
    with trace_annotation("stage"):
        ran.append(1)
    assert ran == [1]


def test_trace_annotation_propagates_body_errors():
    with pytest.raises(ValueError, match="boom"):
        with trace_annotation("stage"):
            raise ValueError("boom")


def test_stage_timer_records_failed_stage():
    t = StageTimer()
    with pytest.raises(KeyError):
        with t.stage("load"):
            raise KeyError("x")
    assert "load" in t.summary()
