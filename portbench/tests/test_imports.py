"""Nothing under portbench/ imports JAX or the JAX package, and the
reference and the yardstick's arithmetic import nothing of the port.
Top-level module names are compared whole: prdisagg_torch begins with
prdisagg_t, which must not match prdisagg_tpu."""

import ast
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "prdisagg_tpu", "bench"}
STANDALONE = ("reference.py", "arith.py", "synth.py", "trace.py",
              "timing.py", "harness.py")


def imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_jax_anywhere():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not FORBIDDEN & set(imported(f)), f


def test_reference_and_arithmetic_stand_alone():
    for name in STANDALONE:
        assert "prdisagg_torch" not in set(imported(HERE / name)), name


def test_names_compared_whole():
    assert "prdisagg_torch".split(".")[0] not in FORBIDDEN
    assert "jax_free".split(".")[0] not in FORBIDDEN
