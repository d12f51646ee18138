"""The benchmark stays apart from JAX and the JAX package: no module under
``portbench`` imports ``jax``, ``jaxlib``, ``flax`` or ``repro``
(compared as whole top-level names: ``repro_torch`` is the program, not
``repro``), and the plain reference imports nothing of the program."""

import ast
import shutil
import subprocess
import sys

import pytest

from portbench import run, spec

FILES = sorted(spec.HERE.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.HERE)))
def test_no_jax_nor_its_package(path):
    assert not set(_imports(path)) & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_the_whole_names_are_compared():
    import repro_torch  # noqa: F401  (the program: named like, not equal)
    assert "repro_torch" in {m.split(".")[0] for m in sys.modules}
    assert "repro_torch" not in run.loaded_forbidden()


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, 'src');"
            "from portbench import run, serving, reference;"
            "from portbench.reference import compare;"
            "import repro_torch.launch.serve;"
            "print(run.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_result_without_the_chip_or_the_program(tmp_path):
    """Without a CUDA device (this machine), and in a directory holding
    only BENCHMARK.json and the benchmark, the command prints no result
    and exits non-zero."""
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (spec.ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             "yi-6b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True)
        assert out.returncode != 0 and out.stdout == ""
