"""The port stands alone: no JAX and nothing of ``repro`` at import or in its
sources (the package, ``examples/*_torch.py`` and ``chip_smoke.py``), and no
quiet drop to the CPU."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import condensed_matmul as cm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s))",
    re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_reference_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.bridge\n"
        "import repro_torch.train.checkpoint\n"
        "from repro_torch.kernels.condensed_matmul import condensed_matmul\n"
        "from repro_torch.kernels.structured_matmul import condensed_over_active_matmul\n"
        "assert condensed_matmul.scaled_launches == 0\n"
        "assert condensed_over_active_matmul.scaled_launches == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_importing_the_ablation_kernels_and_the_plan_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.kernels.structured_matmul, repro_torch.sparse.plan\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_importing_the_sync_package_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.sync, repro_torch.sync.smoke, repro_torch.launch.engine\n"
        "from repro_torch.sync import delta, channel, publisher, subscriber\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or m == 'repro' or m.startswith('repro.')\n"
        "             or m == 'ml_dtypes')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_importing_the_training_path_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.launch.train, repro_torch.train.trainer, repro_torch.train.state\n"
        "import repro_torch.core.saliency, repro_torch.core.schedule, repro_torch.core.srigl\n"
        "import repro_torch.optim, repro_torch.data.pipeline, repro_torch.kernels.ops\n"
        "import repro_torch.core.rigl, repro_torch.core.set_sparse, repro_torch.core.theory\n"
        "import repro_torch.core.flops, repro_torch.optim.grad_compress\n"
        "import repro_torch.train.elastic\n"
        "from repro_torch.kernels.condensed_matmul import condensed_matmul_dw\n"
        "assert condensed_matmul_dw.launches == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_train_cli_refuses_to_drop_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
                                       *(ROOT / "examples").glob("*_torch.py"),
                                       ROOT / "chip_smoke.py"]))
def test_source_imports_neither_jax_nor_the_reference(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(text), f"{path} imports jax or repro"


def test_forbidden_pattern_catches_what_it_must():
    for line in ("import jax", "from jax import numpy", "import repro.configs",
                 "from repro.sparse import formats", "from repro import configs"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.sparse import formats"):
        assert not FORBIDDEN.search(line), line


def test_entry_points_refuse_to_drop_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke", "--gen", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrapper_takes_the_plain_version_only_on_the_cpu(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version: it
    launches the kernel (CUDA), raises, or, on the meta device (the dry
    run's), gets the kernel's output shape with nothing run or counted."""
    x = torch.zeros((2, 8), device="meta")
    values = torch.zeros((3, 2), device="meta")
    idx = torch.zeros((3, 2), dtype=torch.int32, device="meta")
    before = cm.condensed_matmul.launches

    def plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(cm, "_plain", plain)
    for run in (cm.condensed_matmul, cm.condensed_matmul_decode):
        y = run(x, values, idx)
        assert y.device.type == "meta" and tuple(y.shape) == (2, 3) and y.dtype == x.dtype
    assert cm.condensed_matmul.launches == before
