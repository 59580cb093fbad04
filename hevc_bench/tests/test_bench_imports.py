"""Nothing the command or its reference loads is JAX or the JAX package;
the reference loads nothing of the port either."""

import ast
import os
import subprocess
import sys

import pytest

from hevc_bench import harness


def test_names_compared_whole():
    assert harness.forbidden_modules(["homerhevc_tpu_torch.api", "numpy"]) \
        == []
    assert harness.forbidden_modules(["homerhevc_tpu.api", "jax.numpy",
                                      "jaxlib", "flax.linen"]) == [
        "flax", "homerhevc_tpu", "jax", "jaxlib"]


def _loaded(root, code):
    out = subprocess.run([sys.executable, "-c", code + """
import sys
print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))
"""], cwd=root, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=root))
    return set(out.stdout.split())


def test_reference_loads_no_program(root):
    top = _loaded(root, "import hevc_bench.check, hevc_bench.reference."
                        "decoder, hevc_bench.synth")
    assert not top & {"jax", "jaxlib", "flax", "homerhevc_tpu",
                      "homerhevc_tpu_torch"}


def test_command_loads_no_jax(root):
    top = _loaded(root, "import hevc_bench.harness, hevc_bench.check, "
                        "hevc_bench.card, homerhevc_tpu_torch.api; "
                        "import homerhevc_tpu_torch.app")
    assert "homerhevc_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "homerhevc_tpu"}


@pytest.mark.parametrize("sub", ["reference", "."])
def test_sources_import_no_program(root, sub):
    """The reference's sources name neither package; the harness's name
    only the port."""
    folder = os.path.join(root, "hevc_bench", sub)
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module] if node.level == 0 else []
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "homerhevc_tpu")
                if sub == "reference":
                    assert top != "homerhevc_tpu_torch", (name, m)
