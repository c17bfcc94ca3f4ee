"""Structured JSON-lines logging (utils/log.py) — SURVEY.md §5.5 upgrade."""

import io
import json

import numpy as np
import pytest

from kss_icp.utils.log import JsonlLogger


def _lines(buf):
    return [json.loads(l) for l in buf.getvalue().splitlines()]


def test_emit_fields_and_numpy_coercion():
    buf = io.StringIO()
    log = JsonlLogger(buf)
    log.emit("result", rmse=np.float32(0.01), counts=np.array([1, 2]))
    (rec,) = _lines(buf)
    assert rec["event"] == "result"
    assert rec["rmse"] == pytest.approx(0.01)
    assert rec["counts"] == [1, 2]
    assert "ts" in rec


def test_stage_start_end_duration():
    buf = io.StringIO()
    log = JsonlLogger(buf)
    with log.stage("register", model="Bunny"):
        pass
    start, end = _lines(buf)
    assert start["event"] == "register.start" and start["model"] == "Bunny"
    assert end["event"] == "register.end"
    assert end["seconds"] >= 0


def test_stage_error_event():
    buf = io.StringIO()
    log = JsonlLogger(buf)
    with pytest.raises(ValueError):
        with log.stage("boom"):
            raise ValueError("x")
    events = [r["event"] for r in _lines(buf)]
    assert events == ["boom.start", "boom.error"]


def test_file_sink_appends(tmp_path):
    p = tmp_path / "events.jsonl"
    JsonlLogger(p).emit("a")
    JsonlLogger(p).emit("b")
    recs = [json.loads(l) for l in p.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["a", "b"]
