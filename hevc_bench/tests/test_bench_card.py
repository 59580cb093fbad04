"""On the card: one short run of a cell through the command, traced and
untraced, comes out correct with the contract's keys."""

import json
import subprocess
import sys

import pytest


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_run_on_the_card(card, root, trace):
    res = subprocess.run(
        [sys.executable, "hevc_bench/run.py", "--workload",
         "ldp_1080p_fastest.live", "--seed", str(2 ** 31 + 12345),
         "--seconds", "5", "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert {"launches_per_frame", "frame_ms_p95.live"} <= set(
            line["metrics"])
    else:
        assert {"fps", "setup_s"} <= set(line["metrics"])
