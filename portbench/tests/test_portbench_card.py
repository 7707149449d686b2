"""On the card: both cells at their own size, the port judged correct in
a plain and a traced run, and the control not (run with ``python -m
pytest portbench/tests -m cuda`` on a machine with the card)."""
import pytest

from portbench import calibrate, compare, harness, spec
from portbench.tests.conftest import CELLS


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    cell = spec.load_cell(name)
    line, *_ = harness.run_cell(cell, 2 ** 31 + 21, 1.0, False, card)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    traced, *_ = harness.run_cell(cell, 2 ** 31 + 22, 1.0, True, card)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["launches_per_step"]["value"] > 0
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    cell = spec.load_cell(name)
    _, _, run = harness.run_cell(cell, 2 ** 31 + 23, 0.0, False, card)
    values = calibrate.control_numbers(cell, 2 ** 31 + 23, card,
                                       run["port"]["stage_in"], run["ref"])
    assert not compare.judge(values, cell.config["limits"]), values
