"""The port's static analysers (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``):

* every module of ``repro_torch/analysis`` is the JAX package's, apart from
  a listed set of lines (the package's name in docstrings and hints, and
  the witness's imports of ``coordination``);
* the port's ``pdlint`` is clean on ``src/repro_torch/core`` and
  ``src/repro_torch/analysis``, and its CLI exits clean there;
* on the fixtures of ``tests/test_pdlint.py`` (one case a rule,
  PD-L001...L006), the port's ``pdlint`` gives the JAX one's findings, field
  for field, and those findings pass that file's own assertions;
* the port's static lock graph of its ``core/coordination.py`` equals the
  JAX one's of the JAX file, and the port witness's observed edges under a
  store workload lie in it.

Pure stdlib ``ast`` on both sides: no tolerance, every comparison exact."""

import ast
import dataclasses
import difflib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.lockgraph import build_lock_graph as jax_build_lock_graph
from repro.analysis.model import build_project as jax_build_project
from repro.analysis.pdlint import run as jax_run
from repro.analysis.rules import list_rules as jax_list_rules
from repro_torch.analysis import witness as port_witness
from repro_torch.analysis.lockgraph import build_lock_graph
from repro_torch.analysis.model import build_project
from repro_torch.analysis.pdlint import EXIT_CLEAN, run
from repro_torch.analysis.rules import list_rules
from repro_torch.core.coordination import CoordinationStore

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
JAX_DIR, PORT_DIR = SRC / "repro" / "analysis", SRC / "repro_torch" / "analysis"
CORE = SRC / "repro_torch" / "core"

# the lines in which the copy differs from the JAX package: (JAX line, port line)
COPY_EDITS = {
    "__init__.py": [
        ("``pdlint`` (:mod:`repro.analysis.pdlint`) statically enforces the\n",
         "``pdlint`` (:mod:`repro_torch.analysis.pdlint`) statically enforces the\n"),
        ("concurrency contracts PR 7's sharded store introduced; the lock-order\n",
         "concurrency contracts of the port's sharded store (``src/repro_torch/core``);\n"),
        ("witness (:mod:`repro.analysis.witness`) validates the static lock graph\n",
         "the lock-order witness (:mod:`repro_torch.analysis.witness`) validates the\n"),
        ("against real executions when ``REPRO_LOCK_WITNESS=1``.\n",
         "static lock graph against real executions when ``REPRO_LOCK_WITNESS=1``.\n"),
    ],
    "pdlint.py": [
        ("    python -m repro.analysis.pdlint src/repro/core [more paths...]\n",
         "    python -m repro_torch.analysis.pdlint src/repro_torch/core [more paths...]\n"),
        ("    python -m repro.analysis.pdlint --list-rules\n",
         "    python -m repro_torch.analysis.pdlint --list-rules\n"),
        ("    python -m repro.analysis.pdlint --select PD-L002,PD-L005 src/repro/core\n",
         "    python -m repro_torch.analysis.pdlint --select PD-L002,PD-L005 "
         "src/repro_torch/core\n"),
        ('        print("pdlint: no paths given (try src/repro/core)", file=sys.stderr)\n',
         '        print("pdlint: no paths given (try src/repro_torch/core)", file=sys.stderr)\n'),
    ],
    "witness.py": [(
        "    import repro.core.coordination as coordination\n",
        "    from ..core import coordination\n",
    )] * 2,
}


def _edits(jax_path: Path, port_path: Path):
    """The (JAX line, port line) replacements that turn one file into the
    other; raises on any other kind of difference."""
    a = jax_path.read_text().splitlines(keepends=True)
    b = port_path.read_text().splitlines(keepends=True)
    out = []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        assert op == "replace" and i2 - i1 == j2 - j1, (port_path, op, a[i1:i2], b[j1:j2])
        out.extend(zip(a[i1:i2], b[j1:j2]))
    return out


NAMES = sorted(p.name for p in JAX_DIR.glob("*.py"))


def test_analysis_copy_has_every_module():
    assert NAMES == ["__init__.py", "lockgraph.py", "model.py", "pdlint.py", "rules.py",
                     "witness.py"]
    assert sorted(p.name for p in PORT_DIR.glob("*.py")) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_analysis_copy_is_the_jax_packages(name):
    assert _edits(JAX_DIR / name, PORT_DIR / name) == COPY_EDITS.get(name, [])


def test_port_imports_no_jax_package_analysis():
    """No module of the port imports the JAX package (``repro.analysis``
    included): every import in ``src/repro_torch`` is checked by ``ast``."""
    for path in (SRC / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            assert not any(n == "repro" or n.startswith("repro.") for n in names), (path, names)


# ------------------------------------------------------------ the port's tree
def test_port_tree_is_clean():
    findings, project = run([CORE, PORT_DIR], select=None)
    assert project.errors == []
    assert findings == [], "\n".join(f.format() for f in findings)


def test_port_pdlint_cli_exits_clean_on_core():
    """``python -m repro_torch.analysis.pdlint src/repro_torch/core``, with
    the JAX package made unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['repro'] = None\n"
         "from repro_torch.analysis.pdlint import main; sys.exit(main())", "src/repro_torch/core"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == EXIT_CLEAN, proc.stdout + proc.stderr


def test_port_rules_are_the_jax_rules():
    assert list_rules() == jax_list_rules()


def test_port_findings_on_the_shipped_trees_equal_jax():
    """The port's pdlint on the JAX package's core, and JAX's on the port's:
    each tree is clean under either linter."""
    for paths in ([SRC / "repro" / "core"], [CORE]):
        mine, _ = run(paths)
        theirs, _ = jax_run(paths)
        assert [dataclasses.astuple(f) for f in mine] == [dataclasses.astuple(f) for f in theirs]
        assert mine == []


# ------------------------------------------- test_pdlint.py's rule fixtures
def _jax_pdlint_tests():
    """tests/test_pdlint.py loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location("_jax_pdlint_cases",
                                                  Path(__file__).parent / "test_pdlint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RULE_CASES = ["test_l001_store_op_under_store_lock",
              "test_l002_blocking_under_lock_direct_and_transitive",
              "test_l003_mutating_subscriber_callback",
              "test_l004_mutate_then_read_without_barrier",
              "test_l005_same_file_inversion",
              "test_l005_cross_module_inversion",
              "test_l006_scan_materialization_under_stripe"]


@pytest.mark.parametrize("case", RULE_CASES)
def test_port_pdlint_matches_jax_on_rule_fixtures(case, tmp_path, monkeypatch):
    """Each fixture (bad and good) of test_pdlint.py's case linted by both
    packages: the same findings, field for field; the case's own assertions
    then run on the port's findings."""
    mod = _jax_pdlint_tests()
    calls = []

    def both(paths, select=None):
        mine, project = run(paths, select=select)
        theirs, _ = jax_run(paths, select=select)
        assert [dataclasses.astuple(f) for f in mine] == [dataclasses.astuple(f) for f in theirs]
        calls.append(len(mine))
        return mine, project

    monkeypatch.setattr(mod, "run", both)
    getattr(mod, case)(tmp_path)
    assert calls and any(calls), calls  # a bad fixture was linted and flagged


# -------------------------------------------------------------- lock graph
def test_static_lock_graph_equals_jax():
    mine = build_lock_graph(build_project([CORE / "coordination.py"]))
    theirs = jax_build_lock_graph(jax_build_project([SRC / "repro" / "core" / "coordination.py"]))
    assert mine.edges and set(mine.edges) == set(theirs.edges)


@pytest.fixture
def _plain_locks_after():
    yield
    port_witness.uninstall()


def test_port_store_workload_observes_only_static_edges(tmp_path, _plain_locks_after):
    """The port witness's observed edges under a store workload of the
    port's CoordinationStore lie in the port's static lock graph."""
    w = port_witness.install()
    store = CoordinationStore(dispatch="inline", wal_path=str(tmp_path / "store.wal"))
    assert type(store._shards[0].lock).__name__ == "WitnessedLock"
    seen = []
    store.subscribe(lambda ev: seen.append(ev))
    for i in range(50):
        store.set(f"cu:{i}", i)
        store.hset(f"du:{i}", "state", "READY")
    store.push("q", "item")
    assert store.pop("q", timeout=1.0) == "item"
    store.flush_events()
    store.flush_wal()
    assert store.keys("cu:") == sorted(f"cu:{i}" for i in range(50))
    store.close()
    assert w.violations == [] and seen

    static = set(build_lock_graph(build_project([CORE / "coordination.py"])).edges)
    assert w.observed_class_edges(), "the workload nests at least once"
    assert w.unexplained_edges(static) == set()
