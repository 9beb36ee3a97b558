"""The control of ``correct`` at a size a test run holds: the toy cell's
plain reference in the program's place, one precision below what the
configuration states (``benchmark/control.py``), must come out not correct
under the toy's limits on every seed."""
import pytest
import torch

from benchmark.control import control_records
from benchmark.harness import check, traffic as traffic_mod, weights
from benchmark.reference.engine import ReferenceEngine
from benchmark.reference.models.cutr.layers import FP8
from benchmark.tests.toycell import toy_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(tmp_path, seed):
    cell = toy_cell(str(tmp_path))
    scans = traffic_mod.make_scans(cell.traffic, seed)
    capture = check.sample_positions(cell.traffic, seed, scans)
    traffic = dict(cell.traffic, class_bias_lift=weights.lift_for(cell.config, cell.traffic))
    control = ReferenceEngine(cell.config, cell.families, traffic, CPU, detector_dtype=FP8, tower_dtype=FP8,
                              tf32=True, search_dtype=torch.bfloat16)
    records, exports, searches = control_records(control, scans, capture)
    reference = ReferenceEngine(cell.config, cell.families, traffic, CPU)
    readings = check.judge(records, exports, scans, reference, capture,
                           check.sample_searches(searches, cell.traffic, seed),
                           check.sample_keyframes(records, cell.traffic, seed))
    correct, checks = check.verdict(readings, cell.limits)
    assert readings["judged_steps"] >= 1
    assert not correct, checks


def test_the_reference_in_the_programs_place_is_correct(tmp_path):
    """The same drive at the reference's own precision reads 0 everywhere."""
    cell = toy_cell(str(tmp_path))
    seed = 4
    scans = traffic_mod.make_scans(cell.traffic, seed)
    capture = check.sample_positions(cell.traffic, seed, scans)
    traffic = dict(cell.traffic, class_bias_lift=weights.lift_for(cell.config, cell.traffic))
    reference = ReferenceEngine(cell.config, cell.families, traffic, CPU)
    records, exports, searches = control_records(reference, scans, capture)
    readings = check.judge(records, exports, scans, reference, capture,
                           check.sample_searches(searches, cell.traffic, seed),
                           check.sample_keyframes(records, cell.traffic, seed))
    correct, checks = check.verdict(readings, cell.limits)
    assert correct, checks
    assert all(c["value"] == 0.0 for c in checks.values()), checks
