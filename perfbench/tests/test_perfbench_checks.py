"""What decides ``correct``: each reference against the port at a tiny
size on the CPU (both fp32), and the check failing for each fault the
cells can have and for the fp8 control."""
import math

import numpy as np
import pytest
import torch

from perfbench import check, control, inputs
from perfbench.reference import clat_student, plain, pofusion_teacher
from perfbench.tests import tiny


@pytest.mark.parametrize("cell", ["pofusion_teacher.train",
                                  "clat_student.train"])
def test_train_reference_follows_the_port(cell):
    keep = {}
    r = tiny.run(cell, keep=keep)
    got, want = keep["got"], keep["want"]
    # the first step from the same weights, crops and masks; the later
    # steps drift by Adam's sign-like first updates of round-off gradients
    assert abs(got.loss[0] - want.loss[0]) <= 1e-4 * abs(want.loss[0])
    assert r["check"]["grad_gap"]["value"] < 1e-3
    assert r["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("pofusion_teacher.train", "frozen"),
    ("pofusion_teacher.train", "half_batch"),
    ("clat_student.train", "frozen"),
    ("clat_student.train", "half_batch"),
    ("clat_student.serve", "altered"),
    ("pofusion_teacher.serve", "altered"),
    ("clat_student.serve", "dropped"),
    ("pofusion_teacher.serve", "dropped"),
    ("clat_student.serve", "fp8"),
    ("pofusion_teacher.serve", "fp8")])
def test_a_fault_fails_the_check(cell, fault):
    """Each fault, and in a serve cell the fp8 control (the reference in
    fp8 in the program's place), fails the cell's own limits."""
    r = tiny.run(cell, fault=fault)
    assert r["correct"] is False
    failed = [k for k, n in r["check"].items() if n["value"] > n["limit"]]
    assert failed, r["check"]


@pytest.mark.parametrize("cell", tiny.TRAIN_CELLS)
def test_the_train_fp8_control_reads_far_above_the_program(cell):
    """The train control (the reference's first steps in fp8 against its
    fp32 steps on the run's own inputs) at the test's size reads far
    above the fp32 program.  At the cells' own sizes on the card it fails
    their limits (PERF.md gives the readings)."""
    keep = {}
    r = tiny.run(cell, keep=keep)
    numbers, _ = control.train_control(cell, 3000000019, keep, "cpu",
                                       scale=tiny.scale(cell),
                                       man=tiny.manifest())
    program = r["check"]["grad_gap"]["value"]
    assert numbers["grad_gap"] > max(20 * program, 0.01), (numbers, program)


def test_a_missing_branch_reads_as_infinite():
    want = {"hazard_fuse": np.zeros((2, 3)), "scale_fuse": np.ones((2, 3)),
            "hazard_path": np.zeros((2, 3)), "scale_path": np.ones((2, 3))}
    assert check.serve_numbers({"hazard_path": np.zeros((2, 3))},
                               want)["logit_gap"] == math.inf
    assert check.serve_numbers({}, want)["logit_gap"] == math.inf
    assert check.serve_numbers({k: v for k, v in want.items()},
                               want)["logit_gap"] == 0.0


def test_serve_references_match_the_port_exactly_in_fp32():
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.recipes import get_recipe
    from multimodal_learning_tpu_torch.serve.export import make_infer_fn
    opt = get_recipe("teacher", **tiny.OPTIONS)
    for ref, path_only in ((pofusion_teacher, False), (clat_student, True)):
        model = define_model(opt, path_only=path_only)
        shapes = {f"model.{k}": tuple(v.shape)
                  for k, v in model.state_dict().items()}
        w = inputs.make_weights(11, shapes, "cpu")
        model.load_state_dict({k[6:]: v for k, v in w.items()})
        infer = make_infer_fn(opt.replace(mode="path") if path_only
                              else opt, model)
        x = torch.randint(0, 256, (5, 32, 32, 3), dtype=torch.uint8)
        omic = torch.randn(5, 80)
        got = infer(x, omic)
        want = ref.serve({"options": {"cut_fuse_grad": True}}, w, x, omic)
        hazards = [k for k in want if k.startswith("hazard_")]
        assert hazards and set(hazards) <= set(got)
        for k in hazards:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 1.1, -3.3])
    y = plain.fp8(x)
    assert y[0] == 448.0 and y[1] == 1.0 and y[2] == 1.125
    assert y[3] == -3.25


def test_gaps_read_a_missing_leaf_as_infinite():
    want = check.Readings([1.0], {"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 1.0})
    got = check.Readings([1.0], {"a": 1.0}, {"a": 1.0, "b": 1.0})
    assert math.isinf(check.train_numbers(got, want)["grad_gap"])


def test_a_mix_may_name_its_own_chunk():
    """A serve chunk is the configuration's batch unless the traffic file
    gives ``chunk``: a mix at another chunk is a data file alone."""
    from perfbench import harness
    cell = "clat_student.serve"
    sc = tiny.scale(cell)
    sc = {**sc, "traffic": {"chunk": 2, "check_rows": 8}}
    keep = {}
    r = harness.run(cell, 3000000019, 0.5, False, device="cpu", scale=sc,
                    keep=keep, man=tiny.manifest())
    assert r["correct"] is True
    assert len(keep["rows"]) == 4 and len(keep["got"]["hazard_path"]) == 8
