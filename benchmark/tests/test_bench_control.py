"""The control of each cell (the reference in the precision below the
configuration's, in the program's place) fails the cell's limits, at the
cell's own size on the card.  On the card: ``python -m pytest -m cuda
benchmark/tests``."""

import sys

import pytest

from wtvbench import compare, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_manifest()["workloads"]])
def test_control_fails_the_limits(card, workload):
    sys.path.insert(0, spec.BENCH_DIR + "/tools")
    import control

    cell = spec.cell(workload)
    fn = {"serve": control.control_serve, "t2v_train": control.control_t2v,
          "gan_train": control.control_gan}[cell.traffic["kind"]]
    readings = fn(cell, 2 ** 31 + 99, card, control.lower_mode(cell))
    assert any(v > lim for _, v, lim in compare.checks_line(readings, cell.limits)), readings
