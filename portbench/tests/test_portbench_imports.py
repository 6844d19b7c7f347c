"""Nothing under portbench/ imports JAX or the JAX package (compared by
whole top-level name: the port's name begins with the JAX package's), and
the reference imports nothing of the program under test."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "megacrn_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): sorted(set(top_level_imports(f))
                                             & FORBIDDEN) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "megacrn_tpu_torch" not in set(top_level_imports(f)), f


def test_the_top_level_check_is_by_whole_name(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import megacrn_tpu_torch.serve\n"
                     "from megacrn_tpu import config\n")
    assert set(top_level_imports(probe)) == {"megacrn_tpu_torch",
                                              "megacrn_tpu"}
