"""The control (the reference with exactness broken, in the program's
place) comes out not correct on every cell's mix, at a size a test run
holds."""

import json

import pytest

from ktbench import check, control
from ktbench.spec import HERE
from ktbench.clients import make_driver

TINY = {"name": "tiny-rmat", "generator": "rmat", "scale": 7, "edge_factor": 8, "a": 0.57, "b": 0.19,
        "c": 0.19}


@pytest.mark.parametrize("mix, requests", [("decompose_alt2", 6), ("stream_w1", 300)])
@pytest.mark.parametrize("seed", [11, 2_147_483_701, 4_000_000_007])
def test_control_is_not_correct(mix, requests, seed):
    traffic = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    driver = make_driver(TINY, traffic, seed, "cpu")
    rec = control.control_records(driver, requests, seed, "cpu")
    readings, _ = check.compare(driver, rec, "cpu")
    assert not check.verdict(readings)
    assert readings["mismatched_edges"] > 0
