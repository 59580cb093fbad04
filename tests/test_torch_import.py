"""The torch port imports without jax, and chip_smoke.py refuses to run
without a GPU or outside the repository (no result line, non-zero exit).

Each check runs in a fresh interpreter so that this process's own imports
(the other test files import jax) cannot hide an import of jax.
"""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "homerhevc_tpu_torch",
    "homerhevc_tpu_torch.api",
    "homerhevc_tpu_torch.device",
    "homerhevc_tpu_torch.tables",
    "homerhevc_tpu_torch.kernels.build",
    "homerhevc_tpu_torch.ops.transforms",
    "homerhevc_tpu_torch.ops.quant",
    "homerhevc_tpu_torch.ops.intra",
    "homerhevc_tpu_torch.ops.deblock",
    "homerhevc_tpu_torch.ops.sao",
    "homerhevc_tpu_torch.ops.gather",
    "homerhevc_tpu_torch.ops.me",
    "homerhevc_tpu_torch.pipeline.intra_torch",
    "homerhevc_tpu_torch.pipeline.p_torch",
    "homerhevc_tpu_torch.pipeline.p_chunk",
    "chip_smoke",
]


def _python(*argv, cwd: str = ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT if cwd == ROOT else "")
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_modules_do_not_import_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith('jax.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _python("-c", code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    res = _python("chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _python("chip_smoke.py", cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
