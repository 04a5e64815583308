"""The port's fault harness (``horovod_tpu_torch/core/faults.py``) against
the JAX package's (``horovod_tpu/core/faults.py``), on the CPU.

* ``parse_spec`` over a corpus of valid and invalid specs: the same
  clauses, field for field, and the same ``FaultSpecError`` texts.
* The firing schedule of both registries over 3000 seeded invocations
  across sites, ranks, process sets and selectors (``count``, ``prob``,
  ``times``, ``rank``, ``pset``): the same decision at every invocation,
  the same ``InjectedFault`` texts, the same ``times=`` marker files.
* ``_poison`` over every dtype in both modes: the port poisons a torch
  tensor on its own device, the reference a host copy; the bytes are
  compared.  bfloat16 in ``nan`` mode flips the top bit, as the
  reference does (``np.issubdtype(bfloat16, np.floating)`` is False).
* ``install`` / ``install_from_config`` / ``uninstall`` / ``use`` and the
  partition and flap windows.
"""

import logging

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.core import faults as ref_faults
from horovod_tpu_torch.core import faults
from horovod_tpu_torch.core.config import Config
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _clean():
    quiet = [logging.getLogger(n) for n in ("horovod_tpu",
                                             "horovod_tpu_torch")]
    levels = [lg.level for lg in quiet]
    for lg in quiet:
        lg.setLevel(logging.ERROR)
    yield
    for lg, lv in zip(quiet, levels):
        lg.setLevel(lv)
    faults.uninstall()
    ref_faults.uninstall()


VALID = [
    "worker.step:kill@rank=1,count=3",
    "kv.put:error@prob=0.25,times=2",
    "heartbeat:drop@rank=0|2",
    "collective.pre:delay(250)@pset=1",
    "collective.pre:corrupt@rank=1; collective.post:corrupt(bitflip)@count=2",
    "collective.post:corrupt(nan)",
    "ckpt.write:torn@prob=0.1; ckpt.rename:kill@rank=0,count=2",
    "ckpt.fsync:bitflip",
    "kv.put:partition(3000)@rank=3,count=5",
    "kv.get:partition(12.5)",
    "wire.send:drop@rank=0,count=2",
    "wire.recv:slow(100)@rank=3",
    "wire.send:flap(2000)@rank=1,count=5",
    "collective.exec:drop@times=4",
    "worker.step:preempt@rank=1,count=3",
    "data.next:delay(7.5)@times=0",
    "  heartbeat : drop @ rank = 1 , count = 2 ;; ",
    "",
    "kv.get:error@prob=0,times=0; kv.get:error@prob=1",
]

INVALID = [
    "nocolon",
    "bogus.site:drop",
    "kv.put:explode",
    "kv.put:delay(abc)",
    "kv.put:drop@rank",
    "kv.put:drop@rank=x",
    "kv.put:drop@count=0",
    "kv.put:drop@prob=1.5",
    "kv.put:drop@times=-1",
    "kv.put:drop@color=red",
    "wire.send:torn",
    "wire.recv:bitflip",
    "kv.put:torn",
    "wire.send:corrupt",
    "collective.pre:partition(10)",
    "kv.put:slow(10)",
    "heartbeat:flap(10)",
    "kv.put:drop; bad",
]

_FIELDS = ("site", "action", "delay_ms", "corrupt_mode", "partition_ms",
           "flap_ms", "ranks", "pset", "count", "prob", "times", "index",
           "source")


def _clauses(mod, spec):
    return [tuple(getattr(c, f) for f in _FIELDS)
            for c in mod.parse_spec(spec)]


@pytest.mark.parametrize("spec", VALID)
def test_parse_spec_valid_matches_reference(spec):
    assert _clauses(faults, spec) == _clauses(ref_faults, spec)


@pytest.mark.parametrize("spec", INVALID)
def test_parse_spec_error_text_matches_reference(spec):
    with pytest.raises(ref_faults.FaultSpecError) as want:
        ref_faults.parse_spec(spec)
    with pytest.raises(faults.FaultSpecError) as got:
        faults.parse_spec(spec)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


SCHEDULE_SPEC = (
    "kv.put:error@prob=0.3,times=40; "
    "kv.get:drop@count=5,prob=0.5; "
    "heartbeat:drop@rank=0|2,count=3,times=25; "
    "collective.pre:corrupt(nan)@prob=0.2,pset=1; "
    "collective.post:corrupt(bitflip)@count=7,times=3; "
    "collective.pre:delay(0)@rank=1; "
    "wire.send:drop@prob=0.1; "
    "wire.recv:slow(0)@count=11; "
    "collective.exec:drop@pset=2,prob=0.4; "
    "data.next:error@count=2,times=5")
_SITES = ("kv.put", "kv.get", "heartbeat", "collective.pre",
          "collective.post", "wire.send", "wire.recv", "collective.exec",
          "data.next")
_TENSOR_SITES = ("collective.pre", "collective.post")


def _schedule(mod, registry, invocations, tensor, to_array):
    """Each invocation's outcome: dropped or not, the error text, or
    whether the tensor came back poisoned."""
    out = []
    for site, pset in invocations:
        try:
            if site in _TENSOR_SITES:
                got = registry.inject_tensor(site, tensor, pset=pset)
                out.append(("poisoned", not np.array_equal(
                    to_array(got), to_array(tensor), equal_nan=True)))
            else:
                out.append(("drop", registry.inject(site, pset=pset)))
        except mod.InjectedFault as e:
            out.append(("error", str(e)))
    return out


@pytest.mark.parametrize("rank,seed", [(0, 0), (1, 7), (2, 12345)])
def test_firing_schedule_matches_reference(rank, seed, tmp_path):
    rng = np.random.RandomState(seed + 100 * rank)
    invocations = [(_SITES[rng.randint(len(_SITES))],
                    [None, 0, 1, 2][rng.randint(4)]) for _ in range(3000)]
    values = rng.randn(6).astype(np.float32)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = ref_faults.FaultRegistry(ref_faults.parse_spec(SCHEDULE_SPEC),
                                   rank=rank, seed=seed,
                                   state_dir=str(ref_dir))
    port = faults.FaultRegistry(faults.parse_spec(SCHEDULE_SPEC),
                                rank=rank, seed=seed,
                                state_dir=str(port_dir))
    want = _schedule(ref_faults, ref, invocations, values, np.asarray)
    got = _schedule(faults, port, invocations, torch.from_numpy(values),
                    lambda t: t.numpy())
    assert got == want
    assert sum(1 for k, v in got if v and k != "drop") > 50
    # the times= markers: the same files with the same counts
    ref_markers = {p.name: p.read_text()
                   for p in (ref_dir / "faults_fired").iterdir()}
    port_markers = {p.name: p.read_text()
                    for p in (port_dir / "faults_fired").iterdir()}
    assert port_markers == ref_markers and port_markers


def test_times_markers_persist_across_incarnations(tmp_path):
    spec = "kv.put:error@times=2"
    for mod in (ref_faults, faults):
        state = tmp_path / mod.__name__
        fired = []
        for _incarnation in range(3):
            reg = mod.FaultRegistry(mod.parse_spec(spec), rank=0,
                                    state_dir=str(state))
            for _ in range(3):
                try:
                    reg.inject("kv.put")
                    fired.append(0)
                except mod.InjectedFault:
                    fired.append(1)
        assert fired == [1, 1, 0, 0, 0, 0, 0, 0, 0]
        assert (state / "faults_fired" / "clause_0").read_text() == "2"


# -- _poison: the same bits on every dtype ------------------------------------

_DTYPES = [
    (np.float16, torch.float16),
    (ml_dtypes.bfloat16, torch.bfloat16),
    (np.float32, torch.float32),
    (np.float64, torch.float64),
    (np.int8, torch.int8),
    (np.uint8, torch.uint8),
    (np.int16, torch.int16),
    (np.int32, torch.int32),
    (np.int64, torch.int64),
    (np.bool_, torch.bool),
]


def _values(np_dtype, shape, seed):
    rng = np.random.RandomState(seed)
    if np_dtype == np.bool_:
        return rng.rand(*shape) > 0.5
    if np.issubdtype(np_dtype, np.integer):
        info = np.iinfo(np_dtype)
        return rng.randint(max(info.min, -1000), min(info.max, 1000),
                           size=shape).astype(np_dtype)
    return rng.randn(*shape).astype(np.float32).astype(np_dtype)


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("mode", ["nan", "bitflip"])
@pytest.mark.parametrize("np_dtype,dtype", _DTYPES,
                         ids=[str(d) for _, d in _DTYPES])
@pytest.mark.parametrize("shape", [(5,), (3, 4), (1,)])
def test_poison_bits_match_reference(np_dtype, dtype, mode, shape,
                                     monkeypatch):
    x = _values(np_dtype, shape, seed=len(shape) * 11 + shape[0])
    # the reference returns jnp.asarray of its poisoned host copy, which
    # narrows 64-bit dtypes without x64: take the host copy itself
    monkeypatch.setattr(jax.numpy, "asarray", lambda a: a)
    want = np.asarray(ref_faults._poison(x, mode))
    t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) \
        if dtype == torch.bfloat16 else torch.from_numpy(x.copy())
    before = _bytes_of(t)
    got = faults._poison(t, mode)
    assert got.dtype == dtype and got.shape == t.shape
    assert got.device == t.device
    assert _bytes_of(got) == want.tobytes()
    assert _bytes_of(t) == before        # the input is left as it was
    assert _bytes_of(got) != before


def test_poison_bfloat16_nan_mode_flips_the_top_bit():
    """The reference's oddity, kept bit for bit: ``corrupt(nan)`` on a
    bfloat16 tensor flips the sign bit of element 0 (no NaN)."""
    t = torch.tensor([1.5, 2.0], dtype=torch.bfloat16)
    got = faults._poison(t, "nan")
    assert got.tolist() == [-1.5, 2.0]
    f16 = faults._poison(t.to(torch.float16), "nan")
    assert torch.isnan(f16[0]) and f16[1] == 2.0


def test_poison_empty_and_non_contiguous():
    empty = torch.empty(0)
    assert faults._poison(empty, "nan") is empty
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    view = base.t()                         # not contiguous
    got = faults._poison(view, "bitflip")
    want = ref_faults._poison(view.numpy(), "bitflip")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(base, torch.arange(12, dtype=torch.float32)
                       .reshape(3, 4))


# -- module-level arming ------------------------------------------------------

def test_install_uninstall_and_active_flag():
    assert not faults.ACTIVE
    reg = faults.install("kv.put:drop@rank=3", rank=3, seed=5)
    assert faults.ACTIVE and reg.rank == 3 and reg.seed == 5
    assert faults.inject("kv.put") is True
    assert faults.inject("kv.get") is False
    assert faults.install("", rank=0) is None and not faults.ACTIVE
    assert faults.inject("kv.put") is False
    faults.install("collective.pre:corrupt", rank=0)
    t = torch.ones(3)
    assert torch.isnan(faults.inject_tensor("collective.pre", t)[0])
    faults.uninstall()
    assert not faults.ACTIVE
    assert faults.inject_tensor("collective.pre", t) is t


def test_install_from_config_reads_spec_seed_and_state_dir(
        tmp_path, monkeypatch):
    monkeypatch.setenv("HVTPU_FAULT_SPEC", "kv.put:error@prob=0.5")
    monkeypatch.setenv("HVTPU_FAULT_SEED", "9")
    monkeypatch.setenv("HVTPU_FAULT_STATE_DIR", str(tmp_path))
    cfg = Config.from_env()
    assert (cfg.fault_spec, cfg.fault_seed) == ("kv.put:error@prob=0.5", 9)
    reg = faults.install_from_config(cfg, rank=2)
    assert (reg.rank, reg.seed, reg.state_dir) == (2, 9, str(tmp_path))
    monkeypatch.delenv("HVTPU_FAULT_SPEC")
    assert faults.install_from_config(Config.from_env(), rank=0) is None


def test_thread_local_registry_use():
    import threading

    seen = {}
    reg = faults.FaultRegistry(faults.parse_spec("heartbeat:drop"), rank=1)

    def worker():
        faults.use(reg)
        try:
            seen["inside"] = faults.inject("heartbeat")
            seen["active"] = faults.ACTIVE
        finally:
            faults.use(None)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert seen == {"inside": True, "active": True}
    assert faults.inject("heartbeat") is False and not faults.ACTIVE


def test_partition_and_flap_windows_match_reference():
    for mod in (ref_faults, faults):
        reg = mod.install("kv.put:partition(200); wire.send:flap(200)",
                          rank=0)
        assert mod.inject("kv.put") is True          # opens the window
        assert mod.inject("kv.get") is True          # silenced with it
        assert mod.inject("heartbeat") is True
        assert 0.0 < mod.partition_remaining() <= 0.2
        assert mod.inject("wire.send") is True
        assert mod.inject("wire.recv") is True
        assert mod.inject("collective.exec") is True
        assert 0.0 < mod.flap_remaining() <= 0.2
        assert reg.partition_remaining() > 0.0
        mod.uninstall()
        assert mod.partition_remaining() == 0.0


def test_injected_fault_text_matches_reference():
    ref_faults.install("kv.put:error@rank=0", rank=0)
    faults.install("kv.put:error@rank=0", rank=0)
    with pytest.raises(ref_faults.InjectedFault) as want:
        ref_faults.inject("kv.put", detail="k")
    with pytest.raises(faults.InjectedFault) as got:
        faults.inject("kv.put", detail="k")
    assert str(got.value) == str(want.value)
    assert "UNAVAILABLE" in str(got.value)


def test_kill_exits_through_exit_fn():
    codes = []
    reg = faults.FaultRegistry(faults.parse_spec("worker.step:kill"),
                               rank=0, exit_fn=codes.append)
    assert reg.inject("worker.step") is False
    assert codes == [1]
    assert reg.inject("worker.step") is False    # one-shot by default
    assert codes == [1]


def test_preempt_fires_once_and_drops_nothing():
    reg = faults.FaultRegistry(faults.parse_spec("worker.step:preempt"),
                               rank=0)
    assert reg.inject("worker.step") is False
    assert [c._fired for c in reg._by_site["worker.step"]] == [1]
