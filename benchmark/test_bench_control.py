"""The control on the card: the plain reference one step below the stated
precisions (TF32 matmuls; the table gathered in bfloat16 where it is
float32, in float8 where it is bfloat16), put in the program's place at
each cell's own size, fails the cell's limits on three seeds. And a run
without a card prints no result.

    python -m pytest benchmark/test_bench_control.py -q    (on the card)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import checks
import run
from conftest import HERE, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  run.manifest()["workloads"]])
def test_the_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own size")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", cell,
         "--readings", "101,102,103", "--control"], capture_output=True,
        text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        limits = json.load(f)
    rows = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]
    assert len(rows) == 3
    for row in rows:
        assert not checks.judge(row, limits), row


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine without a card")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "office0_hybrid.map", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
