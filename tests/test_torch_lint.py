"""The repository's lint gate (tools/lint.py: no unused import, bare except,
tab in indentation or trailing whitespace; every file byte-compiles)
applied to the port, chip_smoke.py and scan_ab.py, which its ROOTS do not
list: one case per file."""

import compileall
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "quantization_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                   ROOT / "scan_ab.py"]


def lint_module():
    spec = importlib.util.spec_from_file_location("repo_lint", ROOT / "tools" / "lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LINT = lint_module()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_lint_clean(path):
    assert LINT.lint_file(path) == []


def test_everything_byte_compiles():
    assert compileall.compile_dir(str(ROOT / "quantization_tpu_torch"), quiet=2)
    for name in ("chip_smoke.py", "scan_ab.py"):
        assert compileall.compile_file(str(ROOT / name), quiet=2)
