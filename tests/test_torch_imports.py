"""The port stands alone: nothing under prdisagg_torch/, nor chip_smoke.py,
imports JAX, its libraries, the JAX package or its drivers under scripts/
(the protocol drivers in prdisagg_torch/protocols/ keep their own copies).

A static scan, because the test process itself has JAX loaded (the parity
tests import both), which makes a sys.modules check meaningless.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "prdisagg_tpu",
             "scripts")
PORT_FILES = sorted((ROOT / "prdisagg_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "prdisagg_torch/ops/upsample_conv.py" in names
    assert "prdisagg_torch/api/server.py" in names
    assert "prdisagg_torch/ops/gather.py" in names
    assert "prdisagg_torch/train/wgan_gp.py" in names
    assert "prdisagg_torch/ops/stats.py" in names
    for module in ("distributed", "mesh", "spatial"):
        assert f"prdisagg_torch/parallel/{module}.py" in names
    for module in ("crps", "lsd", "evaluate", "parity"):
        assert f"prdisagg_torch/eval/{module}.py" in names
    for module in ("core", "pipeline"):
        assert f"prdisagg_torch/baselines/rainfarm/{module}.py" in names
    for module in ("ingest", "netcdf_io", "download", "native", "indices"):
        assert f"prdisagg_torch/data/{module}.py" in names
    for module in ("watchdog", "stagecache", "profiling"):
        assert f"prdisagg_torch/utils/{module}.py" in names
    for module in ("__init__", "large_domain", "variants", "epoch_curve",
                   "paper", "paper_finish", "l1_rehearsal"):
        assert f"prdisagg_torch/protocols/{module}.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
