"""On the card, at each cell's own size: the control (the reference one
precision lower in the program's place) fails the cell's check, and the
readings it gives stay above the limits that PERF.md set from it.

    python -m pytest portbench/tests/test_portbench_gpu.py -q   (on the card)
"""
import pytest

from portbench import bench, controls

CELLS = [w["name"] for w in bench.spec()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, cuda):
    cell = bench.cell_file(name)
    limits = cell["check"]["limits"]
    got = controls.readings(name, 2 ** 31 + 101, "cuda")["control"]
    assert any(got[k] > limits[k] for k in limits), got
