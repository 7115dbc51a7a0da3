"""chip_smoke.py: its device check, and each phase at a tiny size with the
CPU standing in for the card (the comparisons and their plumbing are what
is tested here; the card run is `python chip_smoke.py`)."""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture
def rep():
    return chip_smoke.Report("cpu stand-in")


@pytest.fixture
def gpu():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; on the card these phases run in "
                    "`python chip_smoke.py`")
    return devices[0]


def test_require_gpu_refuses_cpu_and_names_it(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.devices("cpu"))
    assert e.value.code != 0
    assert "found" in str(e.value.code) and "cpu" in str(e.value.code)


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert out.startswith("card: ")
    assert '"ok"' not in out


def test_report_fails_on_tolerance_and_nonfinite(rep):
    rep.close("t", "inside", [1.0, 2.0], [1.0, 2.0 + 1e-9], tol=1e-6)
    assert not rep.failures
    rep.close("t", "outside", [1.0], [1.1], tol=1e-3)
    rep.close("t", "nan", [float("nan")], [0.0], tol=1.0)
    rep.close("t", "relative", 101.0, 100.0, tol=1e-3, rel=True)
    assert len(rep.failures) == 3


def test_phase_deployed_tick_small(rep, cpu):
    chip_smoke.phase_deployed_tick(rep, cpu, cpu, N=20, ticks=10,
                                   loop_steps=150)
    assert not rep.failures, rep.failures


def test_phase_closed_loop_small(rep, cpu):
    chip_smoke.phase_closed_loop(rep, cpu, cpu, N=20, n_steps=150,
                                 fig8_steps=20)
    assert not rep.failures, rep.failures


@pytest.mark.gpu
def test_phases_on_card(gpu, rep):
    cpu = jax.devices("cpu")[0]
    for _, phase in chip_smoke.PHASES[:4]:
        phase(rep, gpu, cpu)
    assert not rep.failures, rep.failures
