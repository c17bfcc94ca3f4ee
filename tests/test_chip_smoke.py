"""chip_smoke.py refuses to run without a GPU: nonzero exit, no result."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def test_main_without_gpu_exits_nonzero_without_result(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    assert out.strip() == ""


def test_unknown_option_is_refused():
    import pytest

    with pytest.raises(SystemExit):
        chip_smoke.main(["--no-such-phase"])
