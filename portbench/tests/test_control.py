"""The controls at a size a test run holds: the reference one precision
below the configuration's, put in the program's place, fails the cell's
check with the cell's own limits (full widths, small batches, on the
CPU).  The readings the limits were set from are the chip's, at the
cells' own sizes (``portbench/control.py``, PERF.md).  The training
cells' fp8 control reads within 2.5x of sound bf16 runs and fails none
of their limits (PERF.md, section 2), so it has no case here."""

import pytest

from portbench import control
from portbench.tests.small import small_bench


@pytest.mark.parametrize("cell", ["flagship16.serve_f32"])
def test_control_is_not_correct(tmp_path, cell):
    bench = small_bench(tmp_path, widths=False)
    limits = bench.cell_files(cell)[0]["limits"]
    for seed in (1, 2):
        got = control.readings(bench, cell, seed, device="cpu")
        assert any(got[k] > limits[k] for k in limits), (seed, got, limits)
