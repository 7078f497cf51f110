"""The control of `correct`, on the card: each cell at toy size, its check
passed by the program, then the same numbers for the plain reference
computed in TF32 (the precision below the configuration's float32 with
TF32 off) in the program's place, which must fail one of them. The cells'
own sizes are read the same way by `gpu_bench/rehearse.py --control`.

    python -m pytest -m cuda -p no:cacheprovider gpu_bench/tests
"""

import pytest
import torch

import toy
from gpu_bench import run

WORKLOADS = [w["name"] for w in toy.bench()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with `python -m "
                    "pytest -m cuda gpu_bench/tests`")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_tf32_control_is_not_correct(card, workload):
    cfg, mix = toy.toy(workload, card=True)
    res = run.run_cell(toy.bench(), workload, 2 ** 31 + 4057, 0.5,
                       False, device=card, config=cfg, traffic=mix,
                       after=lambda d: d.control_readings())
    assert res["correct"] is True, res["compared"]
    limits = {k: c["limit"] for k, c in res["compared"].items()}
    assert any(res["after"][k] > limits[k] for k in limits), res["after"]


@pytest.mark.cuda
@pytest.mark.parametrize("costreg", ["auto", "dband"])
def test_conv3d_reader_reads_either_route(card, costreg):
    """A traced toy-size generalizable step on cuDNN's 3-D convolutions
    (the default) and on K10's: the reader finds the work on both."""
    cfg, mix = toy.toy("dtu_v0.train", card=True)
    mix = dict(mix, flags=[*mix["flags"], "--costreg_impl", costreg])
    res = run.run_cell(toy.bench(), "dtu_v0.train", 2 ** 31 + 4099, 1.0,
                       True, device=card, config=cfg, traffic=mix)
    assert res["metrics"]["conv3d_device_ms.train"]["value"] > 0
