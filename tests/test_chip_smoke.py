"""chip_smoke.py on the CPU: it refuses to run, and the parts that do
not need a card (the kernel check's comparison with the host oracle,
the phase order and the last line) behave."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke

REPO = Path(__file__).resolve().parents[1]


def test_refuses_non_gpu_backend():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not a GPU" in proc.stderr


def test_kernel_check_runs_every_bucket(capsys):
    chip_smoke.phase_kernel_check(batch_size=8, oracle_sample=2)
    out = capsys.readouterr().out
    for K in (8, 16, 32, 64, 128):
        assert f"K={K} B=8: bit-equal" in out


def _stub_phases(monkeypatch, tmp_path, calls):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}
    monkeypatch.setattr(chip_smoke, "WORKDIR", tmp_path)
    monkeypatch.setattr(chip_smoke, "phase_device", lambda n: dev)
    for name in ("make_workload", "phase_main_path", "phase_host_oracle",
                 "phase_forced_core", "phase_kernel_check",
                 "phase_four_cards"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    return dev


@pytest.mark.parametrize("four_cards", [False, True])
def test_phase_order_and_last_line(monkeypatch, tmp_path, capsys, four_cards):
    calls = []
    dev = _stub_phases(monkeypatch, tmp_path, calls)
    assert chip_smoke.main(["--four-cards"] if four_cards else []) == 0
    if four_cards:
        assert calls == ["make_workload", "phase_four_cards"]
    else:
        assert calls == ["make_workload", "phase_main_path",
                         "phase_host_oracle", "phase_forced_core",
                         "phase_kernel_check"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": dev}
    assert set(json.loads(last)["device"]) == {"platform", "kind", "count"}


def test_failing_phase_prints_no_result(monkeypatch, tmp_path, capsys):
    calls = []
    _stub_phases(monkeypatch, tmp_path, calls)

    def broken(*a, **k):
        chip_smoke.require(False, "assembly differs")

    monkeypatch.setattr(chip_smoke, "phase_host_oracle", broken)
    with pytest.raises(chip_smoke.SmokeFailure, match="assembly differs"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
    assert "phase_forced_core" not in calls
