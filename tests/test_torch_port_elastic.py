"""The elastic slice of the port (``horovod_tpu_torch/elastic``,
``core/{audit,preempt,durable}.py``, the data loader, ``TorchState``)
against the JAX package and its torch frontend on the CPU.

Tolerances: none; every comparison is exact.

* The slice: the narrow ResNet (weights from numpy through
  ``weights.py``) trains 2 epochs of 8 steps under ``hvd.elastic.run``
  with ``TorchState(model, optimizer, data=loader.state)`` and a commit
  a step, in child processes: once uninterrupted; through the port in
  four incarnations (a ``worker.step`` kill at commit 5, exit 1; a
  SIGUSR1 after 3 commits, so the 4th raises HostsUpdatedInterrupt,
  exit 73; a SIGTERM preemption notice after 2 commits, drained at the
  4th, exit 79; the rest, exit 0); and through the JAX package's
  torch frontend in two (the kill, then the rest).  The final
  ``state_dict``s and momentum buffers are bitwise equal across the
  three, the committed steps cover each epoch's permutation exactly
  once, every incarnation starts from the last verified commit, and the
  snapshots left on disk verify in both packages.
* Preemption: the drain coordinator over one fake client reaches the
  reference's decisions; in a 2-rank gloo world
  ``worker.step:preempt@rank=1,count=3`` drains both ranks at one
  boundary (rank 1 exits 79, rank 0 exits 73) and the relaunch loses no
  step.
* Audit: ``digest_tree`` / ``format_report`` equal the reference's on
  numpy-made trees (bfloat16 included); in a 2-rank gloo world a
  perturbed tensor raises ``HvtpuDivergenceError`` naming the leaf and
  the rank.
* The call sites: ``poison_exit_status`` is 73 in an elastic job; the
  controller predicts nothing and its burst gate opens at once while a
  drain is pending; the ``preempt`` fault delivers a notice; a
  relaunched ``init`` replays the journal.
"""

from __future__ import annotations

import collections
import inspect
import signal
import threading
import time
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.core import audit as ref_audit
from horovod_tpu.core import durable as ref_durable
from horovod_tpu.core import exceptions as ref_exc
from horovod_tpu.core import preempt as ref_preempt
from horovod_tpu_torch.core import audit as port_audit
from horovod_tpu_torch.core import durable as port_durable
from horovod_tpu_torch.core import exceptions as port_exc
from horovod_tpu_torch.core import preempt as port_preempt
from torch_port_util import (ELASTIC_EPOCHS, ELASTIC_IMAGES, ELASTIC_BATCH,
                             audit_rank, committed_step, committed_steps,
                             elastic_rank,
                             read_steps, run_incarnation, spawn_world)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

SPE = ELASTIC_IMAGES // ELASTIC_BATCH


# -- the surface ----------------------------------------------------------------

EXCEPTIONS = ("HorovodTpuError", "HorovodInternalError", "HvtpuMismatchError",
              "HvtpuDivergenceError", "HostsUpdatedInterrupt",
              "DrainInterrupt", "NotInitializedError", "StallError")


@pytest.mark.parametrize("name", EXCEPTIONS)
def test_exception_hierarchy_is_the_reference(name):
    ref, port = getattr(ref_exc, name), getattr(port_exc, name)
    assert [c.__name__ for c in port.__mro__] \
        == [c.__name__ for c in ref.__mro__]


def test_interrupts_carry_the_reference_fields():
    for mod in (ref_exc, port_exc):
        e = mod.DrainInterrupt(rank=3)
        assert (e.rank, e.skip_sync) == (3, False)
        assert mod.HostsUpdatedInterrupt(skip_sync=True).skip_sync
    assert hvd.DrainInterrupt is port_exc.DrainInterrupt
    assert hvd.elastic.HostsUpdatedInterrupt is port_exc.HostsUpdatedInterrupt


def test_exit_codes_are_the_reference():
    from horovod_tpu.core.retry import FENCE_EXIT_CODE as ref_fence
    from horovod_tpu.elastic.worker import RESET_EXIT_CODE as ref_reset
    from horovod_tpu_torch.core.retry import FENCE_EXIT_CODE

    assert (hvd.elastic.RESET_EXIT_CODE, port_preempt.DRAIN_EXIT_CODE,
            FENCE_EXIT_CODE) == (ref_reset, ref_preempt.DRAIN_EXIT_CODE,
                                 ref_fence) == (73, 79, 89)


def _params(fn):
    return [p for p in inspect.signature(fn).parameters]


SIGNATURES = [
    ("horovod_tpu.torch.elastic:TorchState", "TorchState", ()),
    ("horovod_tpu.torch.elastic:ElasticSampler", "ElasticSampler", ()),
    ("horovod_tpu.elastic:run", "run", ()),
    ("horovod_tpu.elastic:ObjectState", "ObjectState", ()),
    ("horovod_tpu.data:ElasticDataLoader", "ElasticDataLoader", ()),
    ("horovod_tpu.api.checkpoint:Checkpointer", "Checkpointer", ()),
    ("horovod_tpu.api.checkpoint:restore_checkpoint", "restore_checkpoint",
     ("device",)),
]


@pytest.mark.parametrize("ref_path,name,extra", SIGNATURES)
def test_surface_signature_is_the_reference(ref_path, name, extra):
    import importlib

    mod, attr = ref_path.split(":")
    ref = getattr(importlib.import_module(mod), attr)
    from horovod_tpu_torch import data

    port = (data.ElasticDataLoader if name == "ElasticDataLoader"
            else getattr(hvd.elastic, name, None) or getattr(hvd, name))
    assert _params(port) == _params(ref) + list(extra)
    if inspect.isclass(ref):
        public = {m for m in dir(ref) if not m.startswith("_")}
        assert public <= {m for m in dir(port) if not m.startswith("_")}


def test_config_reads_the_elastic_env_alike(monkeypatch):
    from horovod_tpu.core.config import Config as RefConfig
    from horovod_tpu_torch.core.config import Config

    env = {"HVTPU_ELASTIC": "1",
           "HOROVOD_PREEMPT_SIGNAL": "SIGUSR2",
           "HVTPU_PREEMPT_NOTICE_FILE": "/x/notice",
           "HVTPU_DRAIN_GRACE_SECONDS": "7"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref, port = RefConfig.from_env(), Config.from_env()
    for f in ("elastic", "preempt_signal", "preempt_notice_file",
              "drain_grace_seconds"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.elastic and port.drain_grace_seconds == 7.0


# -- the audit ------------------------------------------------------------------

def _numpy_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "model": collections.OrderedDict([
            ("conv.weight", rng.standard_normal((4, 3, 3, 3),
                                                dtype=np.float32)),
            ("fc.bias", rng.standard_normal(5).astype(ml_dtypes.bfloat16)),
            ("steps", np.arange(3, dtype=np.int64))]),
        "opt": {"state": {0: {"momentum_buffer": rng.standard_normal(
            (2, 2)).astype(np.float16)}},
            "param_groups": [{"lr": 0.1, "nesterov": False,
                              "foreach": None, "params": [0]}]},
        "epoch": 2, "shape": (3, "x"), "scalar": np.float32(seed)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return type(tree)((k, _as_torch(v)) for k, v in tree.items())
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if isinstance(tree, np.ndarray):
        if tree.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(tree.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(tree.copy())
    return tree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digest_tree_equals_the_reference(seed):
    tree = _numpy_tree(seed)
    ref = ref_audit.digest_tree(tree)
    assert port_audit.digest_tree(_as_torch(tree)) == ref
    assert port_audit.digest_tree(tree) == ref
    assert "['model']['fc.bias']" in ref and "['opt']['param_groups'][0]" \
        "['foreach']" not in ref


def test_format_report_equals_the_reference():
    trees = [_numpy_tree(0), _numpy_tree(0), _numpy_tree(1)]
    for pkg, conv in ((ref_audit, lambda t: t), (port_audit, _as_torch)):
        per_rank = {r: pkg.digest_tree(conv(t)) for r, t in enumerate(trees)}
        div = pkg._find_divergence(per_rank)
        if pkg is ref_audit:
            want = (div, pkg.format_report("params", div))
        else:
            assert (div, pkg.format_report("params", div)) == want
    assert "divergent ranks [2]" in want[1]


@pytest.fixture(scope="module")
def gloo_audit(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("audit2")
    codes, results = spawn_world(audit_rank, 2, tmp, timeout=90)
    assert codes == [0, 0], codes
    return results


def test_audit_two_ranks_clean(gloo_audit):
    for res in gloo_audit:
        assert res["clean"]["divergent"] == {} and res["clean"]["ranks"] == []


def test_audit_two_ranks_names_the_leaf_and_the_rank(gloo_audit):
    for res in gloo_audit:
        text = res["abort"]
        assert text is not None
        assert "1 tensor(s) differ" in text
        assert "['model']['Dense_0.bias']: divergent ranks [1]" in text
        assert res["warn"]["ranks"] == [1]
        assert list(res["warn"]["divergent"]) == ["['model']['Dense_0.bias']"]


# -- preemption -----------------------------------------------------------------

class _FakeKV:
    """One dict shared by the ranks' coordinators (the JAX client's
    directory read: every key under a prefix)."""

    def __init__(self):
        self.d, self.lock = {}, threading.Lock()

    def key_value_set(self, k, v):
        with self.lock:
            self.d[k] = v

    def key_value_try_get(self, k):
        with self.lock:
            if k not in self.d:
                raise KeyError(f"NOT_FOUND: {k}")
            return self.d[k]

    def key_value_dir_get(self, prefix):
        with self.lock:
            return sorted((k, v) for k, v in self.d.items()
                          if k.startswith(prefix))


def _drain_script(mod, exc_mod):
    """Drive rank 0 and rank 1 (departing) through one drain; returns
    the decisions and the store's keys."""
    kv, exits = _FakeKV(), []
    cs = [mod._DrainCoordinator(rank=r, size=2, grace_s=30.0,
                                notice_file=None, generation=4, client=kv,
                                start_watcher=False, shared_pending=False,
                                exit_fn=exits.append) for r in range(2)]
    a, b = cs
    out = []
    try:
        out.append(("pending0", a.pending, b.pending))
        b.notice("api")
        b._poll_once()
        a._poll_once()
        out.append(("pending1", a.pending, b.pending,
                    sorted(a.draining_ranks()), sorted(b.draining_ranks())))
        out.append(("b3", b.drain_boundary(3)))
        a._poll_once()
        out.append(("a3", a.drain_boundary(3)))
        out.append(("a4", a.drain_boundary(4), "b4", b.drain_boundary(4)))
        try:
            a.finish_drain(4)
            out.append(("a_finish", None))
        except exc_mod.DrainInterrupt as e:
            out.append(("a_finish", type(e).__name__, e.rank))
        b.finish_drain(4)
        out.append(("exits", list(exits)))
        out.append(("again", a.drain_boundary(5), b.drain_boundary(5)))
        state = b.debug_state()
        out.append(("debug", state["departing"], state["reason"],
                    state["drained"], state["plans"]))
    finally:
        for c in cs:
            c.stop()
    return out, sorted(kv.d)


def test_drain_coordinator_decides_as_the_reference():
    ref = _drain_script(ref_preempt, ref_exc)
    port = _drain_script(port_preempt, port_exc)
    assert port == ref
    decisions = dict((d[0], d[1:]) for d in port[0])
    assert decisions["a4"] == (True, "b4", True)
    assert decisions["a_finish"] == ("DrainInterrupt", 1)
    assert decisions["exits"] == ([79],)
    assert port[1] == ["hvtdrain/4/notice/1", "hvtdrain/4/plan/1"]


def test_preempt_fault_delivers_a_notice(monkeypatch):
    from horovod_tpu_torch.core import faults
    from horovod_tpu_torch.core.config import Config

    try:
        port_preempt.install(Config(drain_grace_seconds=60.0), rank=0,
                             size=1)
        faults.install("worker.step:preempt@count=2", rank=0)
        assert not faults.inject("worker.step") and not port_preempt.pending()
        assert not faults.inject("worker.step")
        assert port_preempt.pending()
        assert port_preempt.debug_state()["reason"] == "fault"
    finally:
        faults.uninstall()
        port_preempt.uninstall()
    assert not port_preempt.pending()
    assert signal.getsignal(signal.SIGTERM) is not None


@pytest.fixture(scope="module")
def gloo_drain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drain2")
    state_dir = str(tmp / "state")
    (tmp / "g0").mkdir()
    (tmp / "g1").mkdir()
    gen0 = spawn_world(elastic_rank, 2, tmp / "g0", state_dir, 0,
                       "worker.step:preempt@rank=1,count=3", timeout=90)
    gen1 = spawn_world(elastic_rank, 2, tmp / "g1", state_dir, 1, "",
                       timeout=90)
    steps = {g: [read_steps(tmp / g / f"steps{r}.jsonl") for r in range(2)]
             for g in ("g0", "g1")}
    finals = [torch.load(tmp / "g1" / f"final{r}.pt") for r in range(2)]
    return gen0, gen1, steps, finals, state_dir


def test_drain_two_ranks_agree_on_one_boundary(gloo_drain):
    gen0, gen1, steps, _, _ = gloo_drain
    assert gen0[0] == [73, 79], gen0
    assert gen1[0] == [0, 0], gen1
    # both ranks ran to the drain commit at step 4 (plan = 3 + 1)
    assert [[s["step"] for s in r] for r in steps["g0"]] == [[1, 2, 3, 4]] * 2


def test_drain_relaunch_loses_no_step(gloo_drain):
    _, _, steps, finals, state_dir = gloo_drain
    for r in range(2):
        assert [s["step"] for s in steps["g1"][r]] == list(range(5, 13))
    for key in finals[0]:
        assert torch.equal(finals[0][key], finals[1][key])
    # every sample of each epoch exactly once over both incarnations
    for epoch in range(2):
        seen = sorted(i for g in ("g0", "g1") for r in range(2)
                      for s in steps[g][r] if s["epoch"] == epoch
                      or (s["epoch"] == epoch + 1 and s["step"] == 6 *
                          (epoch + 1))
                      for i in s["idx"])
        assert seen == list(range(48)), epoch
    for seq in port_durable.list_snapshots(state_dir):
        assert port_durable.verify_snapshot(
            port_durable.snapshot_path(state_dir, seq))


# -- the slice: incarnations in child processes ----------------------------------

PORT_GENS = (  # (extra env, expected exit)
    ({"HVTPU_FAULT_SPEC": "worker.step:kill@count=5"}, 1),
    ({"HVT_USR1_AFTER": "3"}, 73),
    ({"HVT_TERM_AFTER": "2"}, 79),
    ({}, 0),
)
REF_GENS = PORT_GENS[:1] + PORT_GENS[3:]


def _incarnations(tmp, name, pkg, gens):
    state_dir, log, out = tmp / f"state_{name}", tmp / f"{name}.jsonl", \
        tmp / f"{name}.pt"
    codes, resumes, errs = [], [], []
    for g, (env, _) in enumerate(gens):
        resumes.append(committed_step(state_dir, pkg))
        rc, err = run_incarnation(tmp, pkg, state_dir, g, log, out, env)
        codes.append(rc)
        errs.append(err[-2000:])
    return {"pkg": pkg, "codes": codes, "resumes": resumes, "errs": errs,
            "steps": read_steps(log), "final": torch.load(out),
            "state_dir": str(state_dir)}


@pytest.fixture(scope="module")
def elastic_slice(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    return {"plain": _incarnations(tmp, "plain", "port", [({}, 0)]),
            "port": _incarnations(tmp, "port", "port", PORT_GENS),
            "ref": _incarnations(tmp, "ref", "ref", REF_GENS)}


def test_slice_exit_codes(elastic_slice):
    for name, gens in (("plain", [({}, 0)]), ("port", PORT_GENS),
                       ("ref", REF_GENS)):
        run = elastic_slice[name]
        assert run["codes"] == [want for _, want in gens], (name,
                                                           run["errs"])


def _bitwise(a, b):
    return (a["model"].keys() == b["model"].keys()
            and all(torch.equal(a["model"][k], b["model"][k])
                    for k in a["model"])
            and all(torch.equal(x, y) for x, y in zip(a["momentum"],
                                                       b["momentum"])))


def test_slice_resumed_run_is_bitwise_the_uninterrupted_one(elastic_slice):
    assert _bitwise(elastic_slice["port"]["final"],
                    elastic_slice["plain"]["final"])


def test_slice_port_is_bitwise_the_reference_frontend(elastic_slice):
    assert _bitwise(elastic_slice["port"]["final"],
                    elastic_slice["ref"]["final"])
    assert _bitwise(elastic_slice["ref"]["final"],
                    elastic_slice["plain"]["final"])


@pytest.mark.parametrize("name", ["port", "ref"])
def test_slice_each_incarnation_starts_at_the_last_verified_commit(
        elastic_slice, name):
    run = elastic_slice[name]
    for g, resume in enumerate(run["resumes"]):
        first = next(s for s in run["steps"] if s["gen"] == g)
        assert first["step"] == resume + 1, (g, resume, first)
        assert first["start"] == {"epoch": resume // SPE,
                                  "cursor": resume % SPE * ELASTIC_BATCH,
                                  "seed": 0}


def test_slice_committed_steps_cover_each_epoch_once(elastic_slice):
    from horovod_tpu_torch.data import epoch_permutation

    for name in ("plain", "port", "ref"):
        run = elastic_slice[name]
        committed = committed_steps(run["steps"], run["resumes"][1:])
        assert sorted(committed) == list(range(1, SPE * ELASTIC_EPOCHS + 1))
        for step, recs in committed.items():
            # a step run again after a kill drew the same samples
            assert all(r["idx"] == recs[0]["idx"] for r in recs)
            assert {r["device"] for r in recs} == {"cpu"}
        for epoch in range(ELASTIC_EPOCHS):
            ids = [i for s in range(epoch * SPE + 1, (epoch + 1) * SPE + 1)
                   for i in committed[s][0]["idx"]]
            assert ids == epoch_permutation(ELASTIC_IMAGES, 0,
                                            epoch).tolist()


def test_slice_snapshots_verify_and_respect_the_keep(elastic_slice):
    for name in ("plain", "port", "ref"):
        d = elastic_slice[name]["state_dir"]
        seqs = port_durable.list_snapshots(d)
        assert len(seqs) == 2
        assert committed_step(d, elastic_slice[name]["pkg"]) \
            == SPE * ELASTIC_EPOCHS
        for seq in seqs:
            path = port_durable.snapshot_path(d, seq)
            assert port_durable.verify_snapshot(path)
            assert ref_durable.verify_snapshot(path)


def test_slice_drain_loses_no_step(elastic_slice):
    """The SIGTERM incarnation exits 79 at its drain commit, and the next
    incarnation resumes from that commit."""
    run = elastic_slice["port"]
    term = [s["step"] for s in run["steps"] if s["gen"] == 2]
    assert run["resumes"][3] == term[-1] == run["resumes"][2] + 4


# -- the call sites ---------------------------------------------------------------

def test_poison_exit_status_is_the_reset_code_in_an_elastic_job(monkeypatch):
    from horovod_tpu_torch.comm import stall
    from horovod_tpu_torch.core import state as core_state

    monkeypatch.setattr(stall, "_poison_gen",
                        core_state.global_state().init_generation)
    monkeypatch.setenv("HVTPU_ELASTIC", "1")
    assert stall.poison_exit_status() == 73
    monkeypatch.setenv("HVTPU_ELASTIC", "0")
    assert stall.poison_exit_status() == 1


def _fake_controller(**kw):
    ns = SimpleNamespace(_stream=True, _predict_on=True, _burst_stable=5,
                         _lock=threading.Lock(), _burst_hint=0,
                         _expected_burst=0, _undrained=1,
                         _last_enqueue_t=time.monotonic(),
                         _stop=threading.Event(), cycle_time_s=10.0,
                         _autotuner=None, _tuned_seen=False)
    ns.__dict__.update(kw)
    return ns


def test_controller_predicts_nothing_while_draining(monkeypatch):
    from horovod_tpu_torch.eager.controller import EagerController

    class _Cache:
        @property
        def cache_size(self):
            raise AssertionError("the drain gate must come first")

    ctrl = _fake_controller(_ctrl=_Cache())
    parsed = SimpleNamespace(cache_bypass=True)
    monkeypatch.setattr(port_preempt, "PENDING", True)
    assert EagerController._try_predict(ctrl, parsed, ["a"]) is False
    monkeypatch.setattr(port_preempt, "PENDING", False)
    with pytest.raises(AssertionError, match="drain gate"):
        EagerController._try_predict(ctrl, parsed, ["a"])


def test_controller_burst_gate_opens_while_draining(monkeypatch):
    from horovod_tpu_torch.eager.controller import EagerController

    monkeypatch.setattr(port_preempt, "PENDING", True)
    for stable in (0, 5):       # the quiet-gap gate and the expected count
        ctrl = _fake_controller(_stream=False, _burst_stable=stable,
                                _expected_burst=7)
        t0 = time.monotonic()
        EagerController._gate_burst(ctrl)
        assert time.monotonic() - t0 < 1.0


def test_relaunched_init_replays_the_journal(tmp_path, monkeypatch):
    from horovod_tpu_torch.core import journal, state as core_state

    monkeypatch.setenv("HVTPU_ELASTIC_STATE_DIR", str(tmp_path))
    journal.reset_default()
    j = journal.default_journal(0)
    j.record("hvtdrain/0/plan/0", "4")
    j.record("hvtpu/ckpt/quorum/0/0/vote/0", "3")
    kv = _FakeKV()
    kv.key_value_set("hvtdrain/0/plan/0", "5")     # re-authored: kept
    monkeypatch.setenv("HVTPU_ELASTIC_GENERATION", "0")
    core_state._replay_journal(kv, 0)
    assert kv.d == {"hvtdrain/0/plan/0": "5"}
    monkeypatch.setenv("HVTPU_ELASTIC_GENERATION", "1")
    core_state._replay_journal(kv, 0)
    assert kv.d == {"hvtdrain/0/plan/0": "5",
                    "hvtpu/ckpt/quorum/0/0/vote/0": "3"}
    journal.reset_default()


def test_torch_state_rolls_back_in_place(monkeypatch):
    from horovod_tpu_torch.data import ElasticDataLoader, SyntheticSource

    monkeypatch.delenv("HVTPU_ELASTIC_STATE_DIR", raising=False)
    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(3, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        loader = ElasticDataLoader(SyntheticSource(12, (3,)), 2)
        state = hvd.elastic.TorchState(model, opt, data=loader.state,
                                       epoch=1)
        loader_state = loader.state
        next(iter(loader))
        model(torch.ones(1, 3)).sum().backward()
        opt.step()
        state.commit()
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        committed = loader.state.state_dict()
        version = loader.state.version
        next(iter(loader))
        model(torch.ones(1, 3)).sum().backward()
        opt.step()
        state.epoch = 5
        state.restore()
        assert all(torch.equal(saved[k], v)
                   for k, v in model.state_dict().items())
        assert loader.state is loader_state
        assert loader.state.state_dict() == committed
        assert loader.state.version > version
        assert state.epoch == 1
        loader.close()
    finally:
        hvd.shutdown()
