"""The PyTorch port stands alone: importing ``incubator_mxnet_tpu_torch``
loads neither JAX nor the JAX package, and no file of the port (nor
``chip_smoke.py``, the ``tools/port_*.py`` scripts or the two-rank test
worker) imports them.  Module names are matched at the
boundary — ``incubator_mxnet_tpu_torch`` starts with the old name."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "incubator_mxnet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tests", "torch_dist_worker.py")]
    out += [os.path.join(REPO, "tools", f)
            for f in os.listdir(os.path.join(REPO, "tools"))
            if f.startswith("port_") and f.endswith(".py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    """Absolute module names a file imports, including
    ``__import__("x")`` / ``importlib.import_module("x")`` calls."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "id", getattr(node.func, "attr", "")) \
                in ("__import__", "import_module"):
            yield node.args[0].value


def test_boundary_matcher():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("incubator_mxnet_tpu")
    assert _forbidden("incubator_mxnet_tpu.serving.generation")
    assert not _forbidden("incubator_mxnet_tpu_torch")
    assert not _forbidden("incubator_mxnet_tpu_torch.parallel")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_file_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, incubator_mxnet_tpu_torch\n"
            "import incubator_mxnet_tpu_torch.serving.generation\n"
            "import incubator_mxnet_tpu_torch.serving.server\n"
            "import incubator_mxnet_tpu_torch.predict\n"
            "import incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet\n"
            "import incubator_mxnet_tpu_torch.ops.fused_conv\n"
            "import incubator_mxnet_tpu_torch.ops.fused_chain\n"
            "import incubator_mxnet_tpu_torch.parallel.step\n"
            "import incubator_mxnet_tpu_torch.optimizer\n"
            "import incubator_mxnet_tpu_torch.gluon.loss\n"
            "import incubator_mxnet_tpu_torch.gluon.block\n"
            "import incubator_mxnet_tpu_torch.gluon.parameter\n"
            "import incubator_mxnet_tpu_torch.gluon.trainer\n"
            "import incubator_mxnet_tpu_torch.gluon.utils\n"
            "import incubator_mxnet_tpu_torch.gluon.nn\n"
            "import incubator_mxnet_tpu_torch.gluon.nn._modules\n"
            "import incubator_mxnet_tpu_torch.initializer\n"
            "import incubator_mxnet_tpu_torch.lr_scheduler\n"
            "import incubator_mxnet_tpu_torch.metric\n"
            "import incubator_mxnet_tpu_torch.name\n"
            "import incubator_mxnet_tpu_torch.ndarray\n"
            "import incubator_mxnet_tpu_torch.autograd\n"
            "import incubator_mxnet_tpu_torch.random\n"
            "import incubator_mxnet_tpu_torch.rtc\n"
            "import incubator_mxnet_tpu_torch.recordio\n"
            "import incubator_mxnet_tpu_torch.io\n"
            "import incubator_mxnet_tpu_torch.pipeline_io\n"
            "import incubator_mxnet_tpu_torch.image\n"
            "import incubator_mxnet_tpu_torch.gluon.data\n"
            "import incubator_mxnet_tpu_torch.gluon.data.vision.datasets\n"
            "import incubator_mxnet_tpu_torch.gluon.data.vision.transforms\n"
            "import incubator_mxnet_tpu_torch.gluon.contrib.data\n"
            "import incubator_mxnet_tpu_torch.gluon.contrib.data.text\n"
            "import incubator_mxnet_tpu_torch.contrib.text\n"
            "import incubator_mxnet_tpu_torch.serving.batcher\n"
            "import incubator_mxnet_tpu_torch.serving.config\n"
            f"bad = sorted(m for m in sys.modules if any(m == f or "
            f"m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
            "print('BAD', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD []" in proc.stdout, proc.stdout
