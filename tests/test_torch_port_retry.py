"""The port's retry engine, store client and key journal
(``horovod_tpu_torch/core/{retry,kv,journal,clock}.py``) against the JAX
package's (``horovod_tpu/core/{retry,journal,clock}.py``), on the CPU.

* ``RetryPolicy`` from the env and its full-jitter backoff for a seeded
  RNG; ``call`` over the same failure sequences, on a fake clock that
  records every sleep: the same attempts and the same sleeps.
* ``ResilientKV`` / ``FencedKV`` over the same logging fake client, under
  the same seeded ``kv.*`` fault specs and transient failures: the same
  log of client operations, the same results and error texts, the same
  fencing (beacon supersession, stale-value rejection, lease expiry).
* ``KeyJournal``: the same folded entries after the same writes,
  tombstones and compaction, and the same replay.
* The port's store client (``core/kv.py``) over ``HashStore``,
  ``FileStore`` and ``TCPStore``: the JAX client's five methods, the
  directory get of the flat and stream namespaces without
  ``list_keys``, and the wrappers above on top of it.
"""

import datetime
import random
import threading

import numpy as np
import pytest
import torch.distributed as dist

from horovod_tpu.core import clock as ref_clock
from horovod_tpu.core import faults as ref_faults
from horovod_tpu.core import journal as ref_journal
from horovod_tpu.core import retry as ref_retry
from horovod_tpu_torch.core import clock, faults, journal, retry
from horovod_tpu_torch.core.kv import StoreKV
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

PAIRS = [(ref_retry, ref_faults, ref_clock), (retry, faults, clock)]


@pytest.fixture(autouse=True)
def _clean():
    yield
    for _r, f, c in PAIRS:
        f.uninstall()
        c.install(None)


class RecordingClock:
    """A fake clock (installed on the calling thread) that records every
    sleep and advances by it."""

    def __init__(self, base):
        self.t = 1000.0
        self.sleeps = []
        self.base = base

    def monotonic(self):
        return self.t

    def wall(self):
        return self.t

    def sleep(self, seconds):
        self.sleeps.append(seconds)
        self.t += max(0.0, seconds)

    def call_later(self, delay_s, fn):
        return self.base.Timer()


def _install_clock(clock_mod):
    fc = RecordingClock(clock_mod)
    clock_mod.install(fc)
    return fc


# -- policies and the call loop -----------------------------------------------

@pytest.mark.parametrize("env", [
    {},
    {"HVTPU_KV_RETRY_ATTEMPTS": "7", "HVTPU_KV_RETRY_BASE_MS": "10",
     "HVTPU_KV_RETRY_MAX_MS": "80", "HVTPU_KV_RETRY_DEADLINE_S": "3"},
    {"HVTPU_KV_RETRY_ATTEMPTS": "2", "HVTPU_KV_RETRY_BASE_MS": "0"},
])
def test_kv_policy_and_backoff_sequence_match_reference(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, got = ref_retry.kv_policy(), retry.kv_policy()
    fields = ("name", "max_attempts", "base_delay_s", "max_delay_s",
              "deadline_s")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]
    for seed in range(5):
        r1, r2 = random.Random(seed), random.Random(seed)
        assert [got.backoff_s(a, r2) for a in range(1, 30)] == \
            [want.backoff_s(a, r1) for a in range(1, 30)]
    assert retry.kv_policy(deadline_s=1.5).deadline_s == 1.5


class Flaky:
    """Fails the first ``fails`` calls with ``exc``; returns its call
    count after."""

    def __init__(self, fails, exc):
        self.fails, self.exc, self.calls = fails, exc, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc
        return self.calls


@pytest.mark.parametrize("fails,exc,attempts,deadline", [
    (2, TimeoutError("x"), 4, None),
    (10, TimeoutError("boom"), 3, None),
    (10, ValueError("nope"), 5, None),
    (50, RuntimeError("UNAVAILABLE: blip"), 100, 0.3),
    (3, RuntimeError("DEADLINE_EXCEEDED"), 6, 30.0),
])
def test_call_attempts_and_sleeps_match_reference(fails, exc, attempts,
                                                  deadline):
    outcomes = []
    for retry_mod, _f, clock_mod in PAIRS:
        fc = _install_clock(clock_mod)
        policy = retry_mod.RetryPolicy(
            name="t", max_attempts=attempts, base_delay_s=0.05,
            max_delay_s=0.4, deadline_s=deadline,
            retryable=retry_mod.kv_retryable)
        fn, seen = Flaky(fails, exc), []
        try:
            result = retry_mod.call(policy, fn, rng=random.Random(3),
                                    on_retry=lambda a, e: seen.append(a))
        except Exception as e:  # noqa: BLE001
            result = f"{type(e).__name__}: {e}"
        outcomes.append((result, fn.calls, fc.sleeps, seen))
        clock_mod.install(None)
    assert outcomes[1] == outcomes[0]


def test_result_based_retry_matches_reference():
    for retry_mod, _f, _c in PAIRS:
        seen = []

        def fn():
            seen.append(1)
            return len(seen)

        policy = retry_mod.RetryPolicy(name="t", max_attempts=5,
                                       base_delay_s=0.0,
                                       retry_result=lambda r: r < 3)
        assert retry_mod.call(policy, fn) == 3
        assert retry_mod.retrying(policy)(lambda: 7)() == 7


_ERRORS = [
    TimeoutError("t"), RuntimeError("UNAVAILABLE: conn"),
    RuntimeError("DEADLINE_EXCEEDED"), RuntimeError("RESOURCE_EXHAUSTED"),
    OSError("failed to connect to all addresses"),
    ConnectionError("Connection reset by peer"), OSError("Broken pipe"),
    RuntimeError("Socket closed"), KeyError("NOT_FOUND: k"),
    RuntimeError("NOT_FOUND: k"), ValueError("bad arg"),
    RuntimeError("coordination service unreachable"),
    RuntimeError("Connection closed by peer"),
]


@pytest.mark.parametrize("err", _ERRORS, ids=lambda e: str(e)[:24])
def test_classifiers_match_reference(err):
    assert retry.kv_retryable(err) == ref_retry.kv_retryable(err)
    assert retry.kv_blocking_retryable(err) == \
        ref_retry.kv_blocking_retryable(err)
    assert retry.is_gloo_infra_error(str(err)) == \
        ref_retry.is_gloo_infra_error(str(err))


def test_store_transport_error_is_retryable():
    """The port's one addition: the store's own transport error type."""
    assert retry.kv_retryable(dist.DistNetworkError("broken"))
    assert not ref_retry.kv_retryable(dist.DistNetworkError("broken"))
    assert retry.GLOO_TEARDOWN.max_attempts == 5
    assert retry.gloo_teardown_policy(2).base_delay_s == 0.0


# -- the KV wrappers over one logging fake -----------------------------------

class LoggingKV:
    """The JAX client's methods over a dict, logging every call; the
    first ``fails`` calls raise a transient error."""

    def __init__(self, fails=0):
        self.d, self.log, self.fails = {}, [], fails
        self.lock = threading.Lock()

    def _op(self, *entry):
        self.log.append(entry)
        if self.fails > 0:
            self.fails -= 1
            raise RuntimeError("UNAVAILABLE: coordinator blip")

    def key_value_set(self, k, v):
        self._op("set", k, v)
        self.d[k] = v

    def key_value_try_get(self, k):
        self._op("try_get", k)
        if k not in self.d:
            raise KeyError(f"NOT_FOUND: {k}")
        return self.d[k]

    def blocking_key_value_get(self, k, timeout_ms):
        self._op("blocking_get", k, timeout_ms)
        if k not in self.d:
            raise TimeoutError(f"DEADLINE_EXCEEDED: {k}")
        return self.d[k]

    def key_value_dir_get(self, prefix):
        self._op("dir_get", prefix)
        return sorted((k, v) for k, v in self.d.items()
                      if k.startswith(prefix))

    def key_value_delete(self, k):
        self._op("delete", k)
        self.d.pop(k, None)


def _script(kv, rng):
    """A seeded sequence of client operations; every result or error is
    recorded."""
    out = []
    keys = [f"p/{i}" for i in range(6)] + ["q/a", "q/b"]
    for _ in range(120):
        op = rng.randint(5)
        k = keys[rng.randint(len(keys))]
        try:
            if op == 0:
                out.append(("set", kv.key_value_set(k, f"v{rng.randint(99)}")))
            elif op == 1:
                out.append(("try_get", kv.key_value_try_get(k)))
            elif op == 2:
                out.append(("dir_get", kv.key_value_dir_get("p/")))
            elif op == 3:
                out.append(("delete", kv.key_value_delete(k)))
            else:
                out.append(("blocking", kv.blocking_key_value_get(k, 5)))
        except Exception as e:  # noqa: BLE001
            out.append((type(e).__name__, str(e)))
    return out


_SPECS = [
    "",
    "kv.put:drop@prob=0.2",
    "kv.get:drop@prob=0.3; kv.put:error@prob=0.25",
    "kv.put:error@count=3,times=4; kv.get:error@prob=0.1",
    "kv.get:partition(5)@count=20",
]


@pytest.mark.parametrize("fenced", [False, True], ids=["resilient", "fenced"])
@pytest.mark.parametrize("spec", _SPECS)
@pytest.mark.parametrize("seed", [0, 5])
def test_kv_wrappers_op_logs_match_reference(spec, seed, fenced):
    runs = []
    for retry_mod, faults_mod, clock_mod in PAIRS:
        fc = _install_clock(clock_mod)
        faults_mod.install(spec, rank=1, seed=seed)
        fake = LoggingKV(fails=3)
        policy = retry_mod.RetryPolicy(
            name="kv", max_attempts=3, base_delay_s=0.05, max_delay_s=0.2,
            deadline_s=10.0, retryable=retry_mod.kv_retryable)
        if fenced:
            kv = retry_mod.FencedKV(fake, rank=1, policy=policy, job_epoch=0,
                                    generation=2, check_every=7,
                                    lease_s=0.0, exit_fn=lambda c: None)
        else:
            kv = retry_mod.ResilientKV(fake, rank=1, policy=policy)
        results = _script(kv, np.random.RandomState(seed))
        runs.append((results, fake.log, fake.d, fc.sleeps))
        faults_mod.uninstall()
        clock_mod.install(None)
    assert runs[1] == runs[0]


def test_fencing_matches_reference():
    """Stamps, stale-value rejection, beacon supersession and the fenced
    client's refusal: the same store contents and errors."""
    runs = []
    for retry_mod, _f, _c in PAIRS:
        fake, exits, out = LoggingKV(), [], []
        old = retry_mod.FencedKV(fake, rank=0, job_epoch=0, generation=0,
                                 exit_fn=exits.append)
        old.key_value_set("k", "v0")
        fake.d["z"] = "\x1fF0.0\x1fold"
        new = retry_mod.FencedKV(fake, rank=1, job_epoch=0, generation=1,
                                 exit_fn=exits.append)
        try:
            new.key_value_try_get("z")
        except KeyError as e:
            out.append(str(e))
        fake.d["p/old"] = "\x1fF0.0\x1fstale"
        new.key_value_set("p/live", "good")
        out.append(new.key_value_dir_get("p/"))
        old._recheck = True
        for op in (lambda: old.key_value_set("k", "stale"),
                   lambda: old.key_value_try_get("k")):
            try:
                op()
            except retry_mod.FencedError as e:
                out.append(str(e))
        out.append(retry_mod.unstamp(fake.d["k"]))
        runs.append((out, exits, fake.d, fake.log))
    assert runs[1] == runs[0]
    assert runs[1][1] == [retry.FENCE_EXIT_CODE]


def test_lease_expiry_matches_reference():
    runs = []
    for retry_mod, _f, clock_mod in PAIRS:
        fc = _install_clock(clock_mod)

        class DownKV(LoggingKV):
            def key_value_set(self, k, v):
                self._op("set", k, v)
                raise RuntimeError("UNAVAILABLE: host gone")

        fake = DownKV()
        fake.d[retry_mod.FENCE_BEACON_KEY] = "0.0"
        policy = retry_mod.RetryPolicy(name="kv", max_attempts=2,
                                       base_delay_s=0.0,
                                       retryable=retry_mod.kv_retryable)
        exits, out = [], []
        kv = retry_mod.FencedKV(fake, rank=0, job_epoch=0, generation=0,
                                lease_s=5.0, policy=policy,
                                exit_fn=exits.append)
        for dt in (0.0, 6.0):
            fc.t += dt
            try:
                kv.key_value_set("a", "1")
            except Exception as e:  # noqa: BLE001
                out.append(f"{type(e).__name__}: {e}")
        runs.append((out, exits, fake.log))
        clock_mod.install(None)
    assert runs[1] == runs[0]
    assert runs[1][1] == [retry.FENCE_EXIT_CODE]


def test_factories_match_reference(monkeypatch):
    fake = LoggingKV()
    kv = retry.fenced_kv(fake, rank=0)
    assert isinstance(kv, retry.FencedKV) and retry.fenced_kv(kv) is kv
    assert retry.fenced_kv(None) is None and retry.resilient_kv(None) is None
    plain = retry.resilient_kv(LoggingKV(), rank=0)
    assert retry.resilient_kv(plain) is plain
    assert retry.fenced_kv(plain, rank=0)._kv is plain._kv
    monkeypatch.setenv("HVTPU_KV_FENCE_DISABLE", "1")
    fallback = retry.fenced_kv(LoggingKV(), rank=0)
    assert type(fallback) is retry.ResilientKV

    class NoDir:
        def key_value_set(self, k, v):
            pass

    assert getattr(retry.ResilientKV(NoDir()), "key_value_dir_get",
                   None) is None


def _kv_counts():
    return {"kv_retries": retry._M_KV_RETRIES.value(),
            "kv_retry_exhausted": retry._M_KV_EXHAUSTED.value()}


def test_counters_count_retries_exhaustions_and_fences():
    before = _kv_counts()
    policy = retry.RetryPolicy(name="kv", max_attempts=4, base_delay_s=0.0,
                               retryable=retry.kv_retryable)
    retry.ResilientKV(LoggingKV(fails=2), policy=policy).key_value_set(
        "a", "1")
    with pytest.raises(RuntimeError):
        retry.ResilientKV(LoggingKV(fails=50),
                          policy=policy).key_value_set("a", "1")
    assert _kv_counts()["kv_retries"] - before["kv_retries"] == 5
    assert _kv_counts()["kv_retry_exhausted"] - \
        before["kv_retry_exhausted"] == 1


# -- the key journal ----------------------------------------------------------

@pytest.mark.parametrize("n_writes", [10, 3000])
def test_journal_entries_match_reference(tmp_path, n_writes):
    rng = np.random.RandomState(n_writes)
    ops = [(rng.randint(4), f"dur/{rng.randint(40)}", f"v{i}")
           for i in range(n_writes)]
    folded, files = [], []
    for mod, sub in ((ref_journal, "ref"), (journal, "port")):
        j = mod.KeyJournal(str(tmp_path / sub), rank=3)
        for op, k, v in ops:
            if op == 0:
                j.forget(k)
            else:
                j.record(k, v)
        reloaded = mod.KeyJournal(str(tmp_path / sub), rank=3)
        fake = LoggingKV()
        fake.d["dur/0"] = "present"
        replayed = reloaded.replay(fake)
        folded.append((j.entries(), reloaded.entries(), len(reloaded),
                       replayed, fake.d))
        files.append((tmp_path / sub / "kvjournal" / "rank3.jsonl")
                     .read_text())
    assert folded[1] == folded[0]
    assert files[1] == files[0]


def test_default_journal_follows_the_state_dir(tmp_path, monkeypatch):
    journal.reset_default()
    monkeypatch.delenv("HVTPU_ELASTIC_STATE_DIR", raising=False)
    assert journal.default_journal(0) is None
    monkeypatch.setenv("HVTPU_ELASTIC_STATE_DIR", str(tmp_path))
    j = journal.default_journal(2)
    assert j.rank == 2 and journal.default_journal() is j
    journal.reset_default()


def test_fenced_writes_ride_the_journal(tmp_path):
    j = journal.KeyJournal(str(tmp_path), rank=0)
    kv = retry.FencedKV(LoggingKV(), rank=0, job_epoch=0, generation=0,
                        exit_fn=lambda c: None, journal=j)
    kv.add_journal_prefix("dur/")
    kv.key_value_set("dur/vote/0", "7")
    kv.key_value_set("ephemeral/x", "1")
    assert j.entries() == {"dur/vote/0": "7"}
    kv.key_value_delete("dur/vote/0")
    assert j.entries() == {}


# -- the port's store client --------------------------------------------------

def _stores(tmp_path):
    return {
        "hash": dist.HashStore(),
        "file": dist.FileStore(str(tmp_path / "filestore"), 1),
        "tcp": dist.TCPStore("127.0.0.1", 0, 1, True,
                             timeout=datetime.timedelta(seconds=30)),
        "prefix": dist.PrefixStore("hvt_kv", dist.HashStore()),
    }


@pytest.mark.parametrize("kind", ["hash", "file", "tcp", "prefix"])
def test_store_kv_methods(kind, tmp_path):
    store = _stores(tmp_path)[kind]
    kv = StoreKV(store, 3, poll_s=0.01)
    with pytest.raises(KeyError, match="NOT_FOUND"):
        kv.key_value_try_get("absent")
    assert not store.check(["absent"])          # the probe wrote nothing
    kv.key_value_set("a", "1")
    kv.key_value_set("a", "2")                  # overwrites
    assert kv.key_value_try_get("a") == "2"
    with pytest.raises(TimeoutError, match="DEADLINE_EXCEEDED"):
        kv.blocking_key_value_get("late", 30)
    threading.Timer(0.05, kv.key_value_set, ("late", "ok")).start()
    assert kv.blocking_key_value_get("late", 5000) == "ok"
    kv.key_value_delete("a")
    with pytest.raises(KeyError):
        kv.key_value_try_get("a")
    # flat namespace: one entry a rank
    kv.key_value_set("hvtwire/0/0/5/0/0", "x")
    kv.key_value_set("hvtwire/0/0/5/0/2", "y")
    kv.key_value_set("hvtwire/0/0/5/1/1", "other attempt")
    assert kv.key_value_dir_get("hvtwire/0/0/5/0/") == [
        ("hvtwire/0/0/5/0/0", "x"), ("hvtwire/0/0/5/0/2", "y")]
    # stream namespace: each rank's newest beat
    for r, beats in ((0, 3), (2, 1)):
        for b in range(beats):
            kv.key_value_set(f"hvtstallhb/1/{r}/{b}", f"r{r}b{b}")
    kv.key_value_delete("hvtstallhb/1/0/0")
    assert kv.key_value_dir_get("hvtstallhb/1/") == [
        ("hvtstallhb/1/0/2", "r0b2"), ("hvtstallhb/1/2/0", "r2b0")]
    assert kv.key_value_dir_get("hvtstallhb/2/") == []


def test_wrappers_on_the_store_client(tmp_path):
    kv = retry.fenced_kv(StoreKV(dist.HashStore(), 2), rank=1)
    kv.key_value_set("hvtstall/1/0/0/1", "allreduce:x")
    assert kv.key_value_dir_get("hvtstall/1/0/0/") == [
        ("hvtstall/1/0/0/1", "allreduce:x")]
    assert kv.key_value_try_get("hvtstall/1/0/0/1") == "allreduce:x"
    with pytest.raises(KeyError):
        kv.key_value_try_get("hvtstall/1/0/0/0")
    faults.install("kv.get:drop@times=1", rank=1)
    assert kv.key_value_dir_get("hvtstall/1/0/0/") == []    # dropped read
    assert len(kv.key_value_dir_get("hvtstall/1/0/0/")) == 1
