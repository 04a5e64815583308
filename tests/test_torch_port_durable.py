"""The port's durable snapshot plane (``horovod_tpu_torch/core/durable.py``)
and checkpointer (``api/checkpoint.py``) against the JAX package's.

Tolerance: none.  The same files give the same directory layout and the
same bytes (payload and ``MANIFEST.json``) in both packages; each
package's ``verify_snapshot`` accepts the other's snapshot; the
``ckpt.*`` faults (torn write, bit flip, dropped rename) are rejected
alike and both fall back to the same commit; ``restore_quorum`` over one
in-memory store agrees on the same seq in both.  Checkpointer restores
are bitwise the saved tensors.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.core import durable as ref_durable
from horovod_tpu.core import faults as ref_faults
from horovod_tpu_torch.core import durable as port_durable
from horovod_tpu_torch.core import faults as port_faults
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

PKGS = {"ref": (ref_durable, ref_faults), "port": (port_durable, port_faults)}


@pytest.fixture(autouse=True)
def _no_fsync(monkeypatch):
    monkeypatch.setenv("HVTPU_CKPT_FSYNC", "0")


def _files(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"state.pkl": rng.bytes(4099), "extra.bin": rng.bytes(17),
            "empty": b""}


def _tree(root) -> dict:
    """relative path -> bytes of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_same_layout_and_manifest_bytes(tmp_path):
    meta = {"step": 7, "world": 2}
    for name, (durable, _) in PKGS.items():
        for seq in (1, 2, 3):
            durable.write_snapshot(str(tmp_path / name), seq, _files(seq),
                                   keep=2, meta=meta)
    ref, port = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert sorted(ref) == sorted(port)
    assert sorted(ref) == sorted(
        f"commits/c_{s:010d}/{n}" for s in (2, 3)
        for n in ("MANIFEST.json", "state.pkl", "extra.bin", "empty"))
    assert ref == port


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_verify_accepts_the_other_packages_snapshot(tmp_path, writer,
                                                    reader):
    w, r = PKGS[writer][0], PKGS[reader][0]
    w.write_snapshot(str(tmp_path), 4, _files(4))
    assert r.verify_snapshot(r.snapshot_path(str(tmp_path), 4))
    assert r.latest_verified(str(tmp_path)) == 4
    assert r.read_snapshot(str(tmp_path), 4) == _files(4)


FAULTS = ("ckpt.write:torn@count=3", "ckpt.write:bitflip@count=3",
          "ckpt.rename:drop@count=3")


@pytest.mark.parametrize("spec", FAULTS)
def test_ckpt_faults_rejected_alike(tmp_path, spec):
    """A fault on the 3rd storage write (snapshot 2's first payload file)
    leaves snapshot 2 unverifiable in both packages; both fall back to
    snapshot 1, and both verifiers agree on every directory."""
    verdicts = {}
    for name, (durable, faults) in PKGS.items():
        root = str(tmp_path / name)
        faults.install(spec, rank=0)
        try:
            durable.write_snapshot(root, 1, {"a": b"x" * 64})
            durable.write_snapshot(root, 2, {"a": b"y" * 64, "b": b"z"})
        finally:
            faults.uninstall()
        verdicts[name] = {
            s: (ref_durable.verify_snapshot(durable.snapshot_path(root, s)),
                port_durable.verify_snapshot(durable.snapshot_path(root, s)))
            for s in durable.list_snapshots(root)}
        assert durable.latest_verified(root) == 1
    assert verdicts["ref"] == verdicts["port"]
    assert verdicts["port"][1] == (True, True)
    assert verdicts["port"][2] == (False, False)


def test_retention_keeps_the_newest_commits(tmp_path, monkeypatch):
    monkeypatch.setenv("HVTPU_CKPT_KEEP", "3")
    kept = {}
    for name, (durable, _) in PKGS.items():
        root = str(tmp_path / name)
        for seq in range(1, 7):
            durable.write_snapshot(root, seq, {"a": bytes([seq])})
        # a dead uncommitted attempt below the newest commit is dropped
        os.makedirs(durable.snapshot_path(root, 2))
        durable.gc_snapshots(root)
        kept[name] = durable.list_snapshots(root)
    assert kept["ref"] == kept["port"] == [4, 5, 6]


class _MemKV:
    """One in-memory coordination store shared by threads."""

    def __init__(self):
        self._d, self._cv = {}, threading.Condition()

    def key_value_set(self, key, value):
        with self._cv:
            self._d[key] = value
            self._cv.notify_all()

    def blocking_key_value_get(self, key, timeout_ms):
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cv:
            while key not in self._d:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"DEADLINE_EXCEEDED: {key}")
                self._cv.wait(left)
            return self._d[key]


def _quorum(durable, kv, votes, namespace):
    out = [None] * len(votes)

    def vote(r):
        out[r] = durable.restore_quorum(
            kv, rank=r, size=len(votes), local_best=votes[r],
            namespace=namespace, timeout_s=10)

    threads = [threading.Thread(target=vote, args=(r,))
               for r in range(len(votes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("votes,want", [([5, 3, 4], 3), ([5, None, 4], None),
                                        ([2, 2, 2], 2)])
def test_restore_quorum_agrees_alike(votes, want):
    kv = _MemKV()
    ref = _quorum(ref_durable, kv, votes, "ref")
    port = _quorum(port_durable, kv, votes, "port")
    assert ref == port == [want] * len(votes)


def test_writer_surfaces_a_failed_write_on_flush():
    w = port_durable.DurableWriter(name="test-writer")

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="durable background write"):
        w.flush()
    w.submit(lambda: None)     # the error was consumed
    w.close()


@pytest.fixture
def port_world():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_checkpointer_round_trip_is_bitwise(tmp_path, port_world):
    hvd = port_world
    model = torch.nn.Linear(5, 3)
    payload = {"model": model.state_dict(), "step": 11,
               "half": torch.arange(6, dtype=torch.bfloat16)}
    saved = model.weight.detach().clone()
    ckpt = hvd.Checkpointer(str(tmp_path), max_to_keep=2)
    ckpt.save(11, payload)
    # the save snapshotted the tensors: an in-place update after save()
    # does not reach the file
    with torch.no_grad():
        model.weight.add_(1.0)
    ckpt.wait()
    got = ckpt.restore()
    assert got["step"] == 11
    assert torch.equal(got["model"]["weight"], saved)
    assert torch.equal(got["half"], payload["half"])
    assert got["model"]["weight"].device == hvd.device()
    manifest = os.path.join(tmp_path, "step_000000000011", "MANIFEST.json")
    assert port_durable.verify_snapshot(os.path.dirname(manifest))
    assert ref_durable.verify_snapshot(os.path.dirname(manifest))


def test_checkpointer_falls_back_past_a_corrupt_step(tmp_path, port_world):
    hvd = port_world
    for step in (1, 2, 3):
        hvd.save_checkpoint(str(tmp_path), step,
                            {"w": torch.full((4,), float(step))},
                            max_to_keep=2).wait()
    assert hvd.Checkpointer(str(tmp_path)).all_steps() == [2, 3]
    bad = os.path.join(tmp_path, "step_000000000003", "state.pt")
    with open(bad, "r+b") as f:
        f.seek(40)
        f.write(b"\xff")
    ckpt = hvd.Checkpointer(str(tmp_path))
    assert torch.equal(ckpt.restore()["w"], torch.full((4,), 2.0))
    with pytest.raises(ValueError, match="fails manifest verification"):
        ckpt.restore(step=3)
    assert torch.equal(hvd.restore_checkpoint(str(tmp_path), step=2)["w"],
                       torch.full((4,), 2.0))
