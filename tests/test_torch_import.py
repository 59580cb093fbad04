"""The torch port, its CLI launcher homer_app_torch.py and chip_smoke.py
import neither jax nor anything of the JAX package (homerhevc_tpu), and
chip_smoke.py refuses to run without a GPU or outside
the repository (no result line, non-zero exit).

The import check runs in a fresh interpreter so that this process's own
imports (the other test files import jax and homerhevc_tpu) cannot hide
one; a scan of the sources backs it for imports made inside functions.
"""

import glob
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "homerhevc_tpu_torch",
    "homerhevc_tpu_torch.api",
    "homerhevc_tpu_torch.config",
    "homerhevc_tpu_torch.device",
    "homerhevc_tpu_torch.tables",
    "homerhevc_tpu_torch.rate_control",
    "homerhevc_tpu_torch.entropy.bitstream",
    "homerhevc_tpu_torch.entropy.cabac",
    "homerhevc_tpu_torch.entropy.syntax",
    "homerhevc_tpu_torch.entropy.headers",
    "homerhevc_tpu_torch.entropy.native_backend",
    "homerhevc_tpu_torch.entropy.native.gen_layout",
    "homerhevc_tpu_torch.kernels.build",
    "homerhevc_tpu_torch.ops.blocksum",
    "homerhevc_tpu_torch.ops.transforms",
    "homerhevc_tpu_torch.ops.quant",
    "homerhevc_tpu_torch.ops.intra",
    "homerhevc_tpu_torch.ops.deblock",
    "homerhevc_tpu_torch.ops.sao",
    "homerhevc_tpu_torch.ops.sao_host",
    "homerhevc_tpu_torch.ops.interp",
    "homerhevc_tpu_torch.ops.inter_golden",
    "homerhevc_tpu_torch.ops.inter_b",
    "homerhevc_tpu_torch.ops.gather",
    "homerhevc_tpu_torch.ops.me",
    "homerhevc_tpu_torch.pipeline.intra_torch",
    "homerhevc_tpu_torch.pipeline.p_torch",
    "homerhevc_tpu_torch.pipeline.p_chunk",
    "homerhevc_tpu_torch.pipeline.p_graph",
    "homerhevc_tpu_torch.pipeline.b_golden",
    "homerhevc_tpu_torch.pipeline.b_torch",
    "homerhevc_tpu_torch.pipeline.assemble",
    "homerhevc_tpu_torch.parallel",
    "homerhevc_tpu_torch.parallel.sharded",
    "homerhevc_tpu_torch.parallel.intra_bands",
    "homerhevc_tpu_torch.parallel.multihost",
    "homerhevc_tpu_torch.utils.synth",
    "homerhevc_tpu_torch.utils.fixtures",
    "homerhevc_tpu_torch.utils.yuv",
    "homerhevc_tpu_torch.utils.psnr",
    "homerhevc_tpu_torch.utils.profiler",
    "homerhevc_tpu_torch.app",
    "homerhevc_tpu_torch.validate.de265",
    "chip_smoke",
    "homer_app_torch",
]
# the scripts at the root of the repository that run the port
SCRIPTS = ("chip_smoke", "homer_app_torch")


def _python(*argv, cwd: str = ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT if cwd == ROOT else "")
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _port_sources():
    files = glob.glob(os.path.join(ROOT, "homerhevc_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, s + ".py") for s in SCRIPTS]


def test_port_module_list_is_complete():
    listed = {m for m in PORT_MODULES if m not in SCRIPTS}
    for path in _port_sources()[:-len(SCRIPTS)]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if rel.endswith(".__init__"):
            rel = rel[:-len(".__init__")]
        top = rel.rsplit(".", 1)[0]
        assert rel in listed or (path.endswith("__init__.py")
                                 and any(m.startswith(rel + ".")
                                         for m in listed)), rel
        assert top.startswith("homerhevc_tpu_torch")


def test_port_modules_do_not_import_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith('jax.') or k == 'homerhevc_tpu' "
            "or k.startswith('homerhevc_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _python("-c", code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


IMPORT_OF_JAX_PACKAGE = re.compile(
    r"^\s*(import\s+(homerhevc_tpu|jax)\b(?!_)"
    r"|from\s+(homerhevc_tpu|jax)(\.[\w.]+)?\s+import\b)", re.M)


def test_port_sources_name_no_import_of_the_jax_package():
    assert IMPORT_OF_JAX_PACKAGE.search("import homerhevc_tpu.tables")
    assert IMPORT_OF_JAX_PACKAGE.search("    from homerhevc_tpu import api")
    assert IMPORT_OF_JAX_PACKAGE.search("from jax import numpy")
    assert not IMPORT_OF_JAX_PACKAGE.search("import homerhevc_tpu_torch.api")
    assert not IMPORT_OF_JAX_PACKAGE.search(
        "from homerhevc_tpu_torch.api import HomerEncoder")
    for path in _port_sources():
        with open(path) as f:
            hit = IMPORT_OF_JAX_PACKAGE.search(f.read())
        assert hit is None, f"{path}: {hit.group(0).strip()}"


def test_port_commits_no_binary():
    tracked = subprocess.run(["git", "ls-files", "homerhevc_tpu_torch"],
                             cwd=ROOT, capture_output=True, text=True)
    if tracked.returncode != 0:
        tracked_files = [os.path.relpath(p, ROOT) for p in glob.glob(
            os.path.join(ROOT, "homerhevc_tpu_torch", "**", "*"),
            recursive=True) if "_build" not in p]
    else:
        tracked_files = tracked.stdout.split()
    bad = [f for f in tracked_files
           if f.endswith((".so", ".o", ".a")) or f.endswith("layout.h")]
    assert not bad, bad


def test_chip_smoke_fails_without_cuda():
    res = _python("chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _python("chip_smoke.py", cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
