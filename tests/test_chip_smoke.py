"""chip_smoke.py's own logic, on the CPU: it refuses anything but a GPU,
fails loudly, and prints the contract line only when every phase passed."""

import json
import shutil
import subprocess
import sys

import pytest

import chip_smoke


INFO = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_refuses_cpu_device(monkeypatch, capsys):
    monkeypatch.setenv("TPQ_TEST_PLATFORM", "cpu")  # restored after main sets it
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert "no GPU" in str(e.value.code)
    assert '"ok": true' not in capsys.readouterr().out


def test_failed_phase_exits_nonzero_without_result(capsys):
    def boom():
        raise RuntimeError("phase broke")

    rc = chip_smoke.run_phases([("fine", lambda: "fine"), ("boom", boom),
                                ("after", lambda: "still runs")], INFO, "CARD, 700 W")
    out = capsys.readouterr().out
    assert rc == 1
    assert '"ok": true' not in out
    assert "[boom] FAILED" in out and "[after] ok" in out
    assert "FAILED phases: boom" in out


def test_contract_line_is_last_and_exact(capsys):
    rc = chip_smoke.run_phases([("fine", lambda: "fine")], INFO, "CARD, 700 W")
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert lines[-2] == "card: CARD, 700 W"


def test_chips4_selects_only_the_multichip_phase():
    assert chip_smoke.select_phases(4) == ("device", "config5_dist_4cards")
    assert "config5_dist_4cards" not in chip_smoke.select_phases(1)
    assert all(name in chip_smoke.PHASES for name in chip_smoke.select_phases(1))
    with pytest.raises(ValueError):
        chip_smoke.select_phases(2)


def test_fails_outside_a_checkout(tmp_path):
    """Alone in a directory, without the repository, the script fails and
    prints no result."""
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "tpq" in res.stderr
