"""Whole runs of each cell on the CPU at a test's size: the system under
test agrees with the plain reference (``correct`` true), and the control
(the reference in the precision below the configuration's) and each
fault the cell can have, planted under the timed path, come out not
correct. The chip check (``run.py``) is skipped: ``run_cell`` is the
rest of a run."""

import functools

import pytest
import torch

from portbench.drivers import serve, train
from portbench.run import control, run_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
SERVE = ["centerOffsetRes10.serve_slide", "cornerCPoolRes10.serve_slide"]
TRAIN = ["centerOffsetRes10.train_b32", "cornerCPoolRes10.train_b32"]


def run(small_cell, name, system=None, precision=None, seconds=1.0):
    bench, entry, files = small_cell(name, precision)
    if callable(system) and not isinstance(system, type) \
            and not isinstance(system, functools.partial):
        system = system(files)
    result, numbers, limits, _ = run_cell(bench, entry, SEED, seconds, False,
                                          CPU, system=system, files=files)
    return result, numbers


@pytest.mark.parametrize("name", SERVE)
def test_served_slide_agrees_with_the_reference(small_cell, name):
    result, numbers = run(small_cell, name)
    assert result["correct"], numbers
    assert numbers["unmatched"] == 0 and numbers["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"slide_latency_p90",
                                      "serve_throughput", "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", TRAIN)
def test_train_steps_agree_with_the_reference(small_cell, name):
    # float32 on the host: the bfloat16 step is held on the card
    result, numbers = run(small_cell, name, precision="float32")
    assert result["correct"], numbers
    assert numbers["loss_gap"] < 1e-4 and numbers["grad_gap"] < 1e-4
    assert set(result["metrics"]) == {"train_throughput", "setup_s"}


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_control_is_not_correct(small_cell, name):
    result, numbers = run(small_cell, name, precision="float32",
                          system=control)
    assert not result["correct"], numbers


@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_is_not_correct(small_cell, name):
    result, numbers = run(small_cell, name, system=serve.AlteredAnswer)
    assert not result["correct"], numbers
    assert numbers["value_gap"] >= serve.ALTERATION / 2


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_is_not_correct(small_cell, name, fault):
    result, numbers = run(small_cell, name, precision="float32",
                          system=train.FAULTS[fault])
    assert not result["correct"], numbers


def test_port_systems_are_the_default():
    assert issubclass(train.HalfBatch, train.System)
    assert issubclass(serve.AlteredAnswer, serve.System)
