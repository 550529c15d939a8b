"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program; top-level module names are
compared whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "chexpert_tpu"}


def imported(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere():
    bad = {str(p.relative_to(BENCH)): sorted(set(imported(p)) & FORBIDDEN)
           for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    bad = {str(p.relative_to(BENCH)): sorted(set(imported(p)) & (FORBIDDEN | {"chexpert_tpu_torch"}))
           for p in (BENCH / "reference").rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "sample.py"
    f.write_text("import chexpert_tpu_torch.models\nfrom chexpert_tpu.ops import x\n"
                 "import jaxlib.xla_client\nimport importlib\n"
                 "importlib.import_module('flax.linen')\n")
    assert set(imported(f)) & FORBIDDEN == {"chexpert_tpu", "jaxlib", "flax"}
