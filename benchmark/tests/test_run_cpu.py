"""A whole run of each cell's driver through the harness's `run`, on the
CPU at a small size (the plain path, which the reference copies): the
outputs agree with the reference to the bit and `correct` comes out
true."""

import pytest
import torch

import harness
from small import small_cell


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


E2E = [{"name": "scans_per_s", "unit": "scans/s"}, {"name": "scan_ms_p95", "unit": "ms"},
       {"name": "setup_s", "unit": "s"}]


@pytest.mark.parametrize("name,frames,steps", [("mulran_os1_64.frontend", 6, 6),
                                               ("kitti_hdl64.fleet8", 6, 12)])
def test_a_small_run_is_correct(name, frames, steps):
    cell, config = small_cell(name, frames)
    cell["limits"] = {k: 0 for k in cell["limits"]}  # the plain path against its copy: exact
    result = harness.run(cell, config, 2**31 + 7, 0.0, 0, torch.device("cpu"), E2E, steps=steps)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"scans_per_s", "scan_ms_p95", "setup_s"}
    assert list(result)[-1] == "compared"
