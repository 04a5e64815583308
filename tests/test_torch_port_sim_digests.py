"""``chip_smoke.py``'s pinned table of the reference simulator's digests
(``SIM_DIGESTS``), held to the reference and to the port on the CPU.

Every row (the 15 scenarios at 64 ranks, ``steady-drain`` and
``compression-negotiation`` at 256, seed 7) is recomputed from the
reference (``horovod_tpu/sim``) under ``PYTHONHASHSEED=0``, so the table
cannot go stale, and from the port (``horovod_tpu_torch/sim``, its
controller scenarios with ``device="cpu"``): the sha256 of the event
log's canonical JSONL and of the canonical ``stats`` JSON must equal the
row in both.  On the card the smoke's ``sim`` phase holds the port's
runs there (payloads on ``cuda:0``, ``steady-drain`` at 256 through the
CLI) to the same rows.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from torch_port_sim_util import run_both  # noqa: E402
from torch_port_util import no_leaked_reference  # noqa: E402,F401

pytestmark = pytest.mark.sim

ROWS = sorted(chip_smoke.SIM_DIGESTS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {}
    for key in ROWS:
        name, ranks = key.split("@")
        cases[key] = [name, int(ranks), chip_smoke.SIM_SEED, {}]
    # steady-drain at 256 (~25 s here) alone; the rest in two halves
    rest = [k for k in ROWS if k != "steady-drain@256"]
    groups = [["steady-drain@256"], rest[0::2], rest[1::2]]
    return run_both(cases, str(tmp_path_factory.mktemp("sim_digests")),
                    groups=groups)


def test_table_covers_the_catalog():
    from horovod_tpu_torch.sim import SCENARIOS

    assert ROWS == sorted([f"{n}@64" for n in SCENARIOS]
                          + ["steady-drain@256",
                             "compression-negotiation@256"])


@pytest.mark.parametrize("pkg", ["horovod_tpu", "horovod_tpu_torch"])
@pytest.mark.parametrize("key", ROWS)
def test_row_is_the_runs_digest(runs, pkg, key):
    got = runs[pkg][key]
    assert (got["sha256"], got["stats_sha256"]) == \
        chip_smoke.SIM_DIGESTS[key], f"{pkg} {key}"


def test_sim_digests_is_the_canonical_form(runs):
    import json

    got = runs["horovod_tpu_torch"]["steady-drain@64"]
    with open(got["log"]) as f:
        events = [json.loads(line) for line in f]
    assert chip_smoke.sim_digests(events, got["stats"]) == (
        got["sha256"], got["stats_sha256"])
