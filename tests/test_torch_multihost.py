"""The port's multi-process GOP pipeline (homerhevc_tpu_torch/parallel/
multihost.py) on the CPU: two processes over gloo on 127.0.0.1, the
configurations of the JAX package's tests/test_multihost.py (128x64, 8
frames of synth_clip seed 3, QP 30, CTU 32, span 4, SAO, sign hiding;
intra_period 0, and 6, whose IDR at POC 6 falls inside the second span).

Both processes' stitched streams must equal each other and the JAX
package's single-process session (the fixture's `mh_ip*_small` hashes,
recorded from homerhevc_tpu.api.HomerEncoder.encode_frame frame by frame).
Every wait is bounded: each worker's output is read with a timeout and the
worker killed when it expires, the process group's rendezvous and
collectives time out (multihost.TIMEOUT), and each worker leaves the group
(GopPipeline.close). Tolerance: exact, byte for byte.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from homerhevc_tpu_torch.parallel import multihost
from homerhevc_tpu_torch.utils import fixtures as fx
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")
WORKER_TIMEOUT_S = 240

WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[5])
import torch
torch.set_num_threads(1)
from homerhevc_tpu_torch.parallel import multihost
from homerhevc_tpu_torch.utils import fixtures as fx
pid, nproc, port, run = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
multihost.init(pid, nproc, coordinator="127.0.0.1:" + port)
pipe = multihost.GopPipeline(fx.run_config(run), span=4, device="cpu")
try:
    aus = pipe.encode(fx.clip(run))
finally:
    pipe.close()
print(json.dumps(fx.au_digest(aus)))
"""


def _free_port() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return str(port)


def _want(run):
    with open(FIXTURE) as f:
        return json.load(f)[run]["aus"]


@pytest.mark.parametrize("intra_period", [0, 6])
def test_two_process_pipeline_matches_single_process(intra_period):
    run = f"mh_ip{intra_period}_small"
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), "2", port, run, ROOT],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    streams = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert streams[0] == streams[1]
    assert streams[0] == _want(run)


def test_one_process_pipeline_matches_single_process():
    """Without a process group the pipeline is one process taking every
    span in turn, through seed_reference at each boundary."""
    run = "mh_ip6_small"
    pipe = multihost.GopPipeline(fx.run_config(run), span=4, device="cpu")
    assert (pipe.pid, pipe.nproc) == (0, 1)
    aus = pipe.encode(fx.clip(run))
    pipe.close()
    assert fx.au_digest(aus) == _want(run)


def test_bcast_from_without_a_group_returns_copies():
    a = np.arange(6, dtype=np.uint8).reshape(2, 3)
    (b,) = multihost._bcast_from([a], 0)
    assert b.dtype == a.dtype and np.array_equal(a, b)
    b[0, 0] = 9
    assert a[0, 0] == 0
    multihost.init(0, 1)            # one process: no group is created
    import torch.distributed as dist
    assert not dist.is_initialized()
