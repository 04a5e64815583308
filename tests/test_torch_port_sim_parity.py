"""The port's fabric simulator (``horovod_tpu_torch/sim``) held byte for
byte against the reference's (``horovod_tpu/sim``).

Every scenario of the catalog at 16 virtual ranks with seed 7
(``fleet-service`` at 64: at 16 ranks the reference's own run fails its
"rolled-back cursor replayed no batch" assertion), the variants that
``tests/test_sim.py`` runs (``steady-drain`` at 4 steps, ``kv-brownout``
at 3, the planted divergence of ``thundering-rendezvous``, ``lossy-link``
at 8 ranks with seed 3 with and without ``baseline=True``) and the CLI's
``bench`` negotiation run: each package runs every case in one
subprocess under ``PYTHONHASHSEED=0`` (``tests/torch_port_sim_util.py``),
the port's controller scenarios with their payloads on the CPU.  Each
case's event log must be byte-identical to the reference's (a failure
names the first line that differs) and its ``stats`` equal, the KV op
counts included.

The 1024-rank cases of ``tests/test_sim.py``'s scale tier are mirrored
under ``slow`` at the end, on the port alone.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_sim_util import first_difference, run_both  # noqa: E402
from torch_port_util import no_leaked_reference  # noqa: E402,F401

pytestmark = pytest.mark.sim

CASES = {
    "thundering-rendezvous": ["thundering-rendezvous", 16, 7, {}],
    "steady-drain": ["steady-drain", 16, 7, {}],
    "rolling-preemption": ["rolling-preemption", 16, 7, {}],
    "kill-blacklist": ["kill-blacklist", 16, 7, {}],
    "kv-brownout": ["kv-brownout", 16, 7, {}],
    "straggler-tail": ["straggler-tail", 16, 7, {}],
    "stream-matrix": ["stream-matrix", 16, 7, {}],
    "compression-negotiation": ["compression-negotiation", 16, 7, {}],
    "checkpoint-storm": ["checkpoint-storm", 16, 7, {}],
    "anomaly-detection": ["anomaly-detection", 16, 7, {}],
    "coordinator-loss": ["coordinator-loss", 16, 7, {}],
    "partition-storm": ["partition-storm", 16, 7, {}],
    "lossy-link": ["lossy-link", 16, 7, {}],
    "multi-job-arbiter": ["multi-job-arbiter", 16, 7, {}],
    "fleet-service-64": ["fleet-service", 64, 7, {}],
    "steady-drain-steps4": ["steady-drain", 16, 7,
                            {"steps": 4, "durable_every": 2}],
    "kv-brownout-steps3": ["kv-brownout", 16, 7, {"steps": 3}],
    "thundering-rendezvous-diverge": ["thundering-rendezvous", 16, 7,
                                      {"diverge_rank": 5}],
    "lossy-link-8-seed3": ["lossy-link", 8, 3, {}],
    "lossy-link-8-seed3-baseline": ["lossy-link", 8, 3,
                                    {"baseline": True}],
    "bench-negotiation": ["bench-negotiation", 16, 7, {}],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(CASES, str(tmp_path_factory.mktemp("sim_parity")),
                    shards=2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_event_log_is_the_references(runs, case):
    ref, port = runs["horovod_tpu"][case], runs["horovod_tpu_torch"][case]
    diff = first_difference(ref["log"], port["log"])
    assert diff is None, (
        f"{case}: logs differ first at line {diff[0]}:\n"
        f"  reference: {diff[1]}\n  port:      {diff[2]}")
    assert port["sha256"] == ref["sha256"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_are_the_references(runs, case):
    ref, port = runs["horovod_tpu"][case], runs["horovod_tpu_torch"][case]
    assert port["stats"] == ref["stats"]
    assert port["stats"]["kv_ops"] == ref["stats"]["kv_ops"]


def test_controller_scenarios_ran_on_the_cpu(runs):
    port = runs["horovod_tpu_torch"]
    for case in ("straggler-tail", "stream-matrix",
                 "compression-negotiation", "bench-negotiation"):
        assert port[case]["devices"] == ["cpu"], case
    assert port["steady-drain"]["devices"] is None


# ---------------------------------------------------------------------------
# the scale tier (slow): tests/test_sim.py's TestScale on the port
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestScale:
    def _run(self, name, ranks, **kw):
        from horovod_tpu_torch.sim import run_scenario

        return run_scenario(name, ranks, seed=7, device="cpu", **kw)

    def test_rolling_preemption_1024_acceptance(self):
        final = self._run("rolling-preemption", 1024)[
            "stats"]["phases"]["final"]
        assert final["world_size"] == 1024 - 2
        assert final["resumed_step"] > 0

    def test_rolling_preemption_256(self):
        r = self._run("rolling-preemption", 256)
        assert r["stats"]["phases"]["final"]["world_size"] == 254

    def test_stream_matrix_256(self):
        r = self._run("stream-matrix", 256)
        assert r["stats"]["phases"]["warmup"]["predicted_bursts"] > 0

    def test_multi_job_arbiter_1024(self):
        r = self._run("multi-job-arbiter", 1024)
        assert r["stats"]["phases"]["preempt"]["victims"] == 512
        assert r["stats"]["phases"]["done"]["hi_np"] == 512

    def test_checkpoint_storm_1024(self):
        quorum = self._run("checkpoint-storm", 1024)[
            "stats"]["phases"]["restore_quorum"]
        assert quorum["agreed_seq"] == 3
        assert quorum["quorum_max_s"] > 0

    def test_coordinator_loss_1024(self):
        loss = self._run("coordinator-loss", 1024)[
            "stats"]["phases"]["coordinator_loss"]
        assert loss["fence_exits"] == 1024
        assert loss["replayed_keys"] == 1024
        assert loss["fence_to_recover_s"] > 0

    def test_partition_storm_1024(self):
        storm = self._run("partition-storm", 1024)[
            "stats"]["phases"]["partition_storm"]
        assert storm["recovered"] == len(storm["victims"]) - 1
        assert storm["detect_max_s"] > 0

    def test_lossy_link_1024_acceptance(self):
        ll = self._run("lossy-link", 1024)["stats"]["phases"]["lossy_link"]
        assert ll["restarts"] == 0 and ll["torn"] == 0
        assert ll["retry_rounds"] >= 2
        assert ll["reroutes"] >= 1

    def test_thundering_rendezvous_4096(self):
        r = self._run("thundering-rendezvous", 4096)
        assert r["stats"]["kv_ops"]["put"] == 4096

    def test_fleet_service_4096(self):
        ph = self._run("fleet-service", 4096)["stats"]["phases"]
        assert ph["pool"]["jobs"] == 5000
        assert 0 < ph["intake"]["max_batch"] <= 256
        assert ph["intake"]["queue_full_rejections"] >= 1
        assert ph["crash"]["replayed_duplicates"] >= 1
        assert ph["admission"]["rejected"] > 0

    def test_fleet_service_16384(self):
        ph = self._run("fleet-service", 16384)["stats"]["phases"]
        assert ph["pool"]["slots"] == 16384
        assert ph["pool"]["jobs"] == 5000
        assert 0 < ph["intake"]["max_batch"] <= 256
        assert ph["crash"]["incarnations"] == 2
        assert ph["done"]["done"] > 0.8 * 5000
