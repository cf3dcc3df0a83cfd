"""The control: the plain reference in the precision below the
configuration's, put in the program's place, fails one of the cell's
numbers; the program's readings at the same size pass every one."""

import pytest

from portbench import control, core
from portbench.tests.cells import CELLS, SMALL, cpu_port  # noqa: F401


@pytest.mark.parametrize("seed", [1, 2, 2 ** 32 + 3])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number(cell, seed, cpu_port):
    limits = core.load_workload(cell)["check"]["limits"]
    got = control.control_readings(cell, seed, "cpu", SMALL[cell])
    assert any(got[k] > limits[k] for k in got if k in limits), got


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_every_number(cell, cpu_port):
    limits = core.load_workload(cell)["check"]["limits"]
    got = control.program_readings(cell, 4, 0.3, "cpu", SMALL[cell])
    assert all(got[k] <= limits[k] for k in limits), got
    assert got["failed"] == 0
