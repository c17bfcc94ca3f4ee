"""Interactive terminal viewer (viz/interactive.py) — the reference's
GLUT trackball loop (View.h:1-22, Main_KSS_ICP.cpp:1-14) re-created for
a display-less accelerator host. Tests drive the pure state machine; the TTY
loop (run_interactive) is a thin wrapper around it."""

from __future__ import annotations

import numpy as np


def _viewer(size=(24, 16)):
    from kss_icp.viz.interactive import InteractiveViewer

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    return InteractiveViewer([pts, pts + 0.2], size=size)


def test_keys_mutate_pose_and_zoom():
    v = _viewer()
    r0 = v.trackball.rotation.copy()
    v.handle_key("left")
    assert not np.allclose(v.trackball.rotation, r0)
    v.handle_key("+")
    assert v.zoom > 1.0
    v.handle_key("r")
    assert v.zoom == 1.0
    np.testing.assert_allclose(v.trackball.rotation, np.eye(3), atol=1e-12)
    v.handle_key("q")
    assert not v.running


def test_rotation_changes_frame():
    v = _viewer()
    f0 = v.frame()
    for _ in range(4):
        v.handle_key("up")
    f1 = v.frame()
    assert f0.shape == f1.shape == (16, 24, 3)
    assert not np.array_equal(f0, f1)
    assert v.frames_rendered == 2


def test_ansi_encoding_halfblocks():
    from kss_icp.viz.interactive import image_to_ansi

    img = np.zeros((4, 3, 3), np.uint8)
    img[0, :, 0] = 255          # first pixel row red
    txt = image_to_ansi(img)
    lines = txt.split("\n")
    assert len(lines) == 2                       # 4 px -> 2 half-block rows
    assert lines[0].count("▀") == 3
    assert "38;2;255;0;0" in lines[0]            # fg = upper pixel
    assert "48;2;0;0;0" in lines[0]              # bg = lower pixel
    assert lines[0].endswith("\x1b[0m")


def test_escape_quits():
    v = _viewer()
    v.handle_key("\x1b")
    assert not v.running
