"""On the card only: one short traced run of a cell through the harness."""

import pytest
import torch

from benchmark import harness


@pytest.mark.cuda
def test_short_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = harness.load_cell("offline512_bulk8x10")
    result = harness.run_cell(cell, 2 ** 31 + 5, 1.0, True)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert "ca_fwd_roofline.offline" in result["metrics"]
    assert harness.forbidden_modules() == []
