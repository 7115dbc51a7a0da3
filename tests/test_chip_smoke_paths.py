"""chip_smoke.py's batched, other-path and four-card phases at small
sizes, with the CPU standing in for the card(s)."""
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


def test_phase_batched_small(rep, cpu):
    chip_smoke.phase_batched(rep, cpu, cpu, B=16, N=20, ticks=2, n_check=3)
    assert not rep.failures, rep.failures


def test_phase_other_paths_small(rep, cpu):
    chip_smoke.phase_other_paths(rep, cpu, cpu, flight_ticks=2, soft_N=10,
                                 soft_ticks=5, of_N=30, of_steps=200,
                                 q13_N=20, q13_ticks=3)
    assert not rep.failures, rep.failures


def test_four_cards_on_virtual_cpu_mesh(rep):
    devices = jax.devices("cpu")
    assert len(devices) >= 4  # conftest's virtual 8-device CPU mesh
    chip_smoke.four_cards(rep, devices, B=16, N=20, ticks=2, sweep_B=8,
                          sweep_N=10, sweep_steps=3, N_sp=8)
    assert not rep.failures, rep.failures
