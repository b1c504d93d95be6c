"""A run of a cell on the card through the benchmark's own command: it
skips itself on a machine without one."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness


@pytest.mark.card
def test_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "centerOffsetRes10.serve_slide", "--seed", "2147483659",
         "--seconds", "3", "--trace", "0"], capture_output=True, text=True,
        timeout=600, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_no_card_run_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "centerOffsetRes10.serve_slide", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=str(harness.ROOT))
    assert out.returncode == 2 and out.stdout.strip() == ""
