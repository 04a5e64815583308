"""``tools/hvtpulint``'s clean passes over the port: thread-safety,
kv-discipline, rank-divergence and sim-purity, each with its scan
directory pointed at ``horovod_tpu_torch`` in memory (the tool scans
only the JAX package), report no finding.

Each pass is also shown to reach the port: its own known-bad fixture
(``tests/lint_fixtures``), copied under ``horovod_tpu_torch/`` of a
scratch tree, gives the fixture's findings with the same patched scan
directory.  ``tools/`` is not edited.
"""

import shutil
from pathlib import Path

import pytest

from tools.hvtpulint import (Project, kv_discipline, rank_divergence,
                             sim_purity, thread_safety)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "lint_fixtures"
PORT = "horovod_tpu_torch"

# pass: (its module, the attribute naming what it scans, the value that
# points it at the port, its known-bad fixture tree and the fixture's
# scanned directory inside it)
PASSES = {
    "thread-safety": (thread_safety, "SCAN_DIRS", (PORT,),
                      "thread_safety", "horovod_tpu"),
    "kv-discipline": (kv_discipline, "SCAN_DIR", PORT,
                      "kv_disc_bad", "horovod_tpu"),
    "rank-divergence": (rank_divergence, "SCAN_DIRS", (PORT,),
                        "rank_div", "examples"),
    "sim-purity": (sim_purity, "SIM_DIR", f"{PORT}/sim",
                   "sim_purity_bad", "horovod_tpu/sim"),
}


def _scan(name, root: Path, monkeypatch):
    module, attr, value, _fixture, _sub = PASSES[name]
    monkeypatch.setattr(module, attr, value)
    return module.run(Project(root))


@pytest.mark.parametrize("name", sorted(PASSES))
def test_pass_is_clean_over_the_port(name, monkeypatch):
    module, attr, value, _fixture, _sub = PASSES[name]
    dirs = value if isinstance(value, tuple) else (value,)
    files = Project(REPO).py_files(*dirs)
    assert len(files) >= (8 if name == "sim-purity" else 100)
    findings = _scan(name, REPO, monkeypatch)
    assert [f.format_text() for f in findings] == []


@pytest.mark.parametrize("name", sorted(PASSES))
def test_pass_reaches_the_port(name, tmp_path, monkeypatch):
    """The fixture's bad tree, moved under ``horovod_tpu_torch``, gives
    the same findings through the patched directory as the fixture
    gives the unpatched pass."""
    module, _attr, value, fixture, sub = PASSES[name]
    want = module.run(Project(FIXTURES / fixture))
    assert want
    target = value[0] if isinstance(value, tuple) else value
    shutil.copytree(FIXTURES / fixture / sub, tmp_path / target)
    got = _scan(name, tmp_path, monkeypatch)

    def keyed(findings, prefix):
        return sorted((f.key.replace(prefix, "@"), f.line,
                       f.path.replace(prefix, "@")) for f in findings)

    assert keyed(got, target) == keyed(want, sub)


def test_port_carries_thread_safety_annotations():
    """The thread-safety pass has annotations to check in the port."""
    hits = [p for p in Project(REPO).py_files(PORT)
            if "hvtpulint: guarded-by" in p.read_text()]
    assert hits
