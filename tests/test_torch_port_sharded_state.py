"""``ShardedTorchState`` (``horovod_tpu_torch/elastic/state.py``) on the
CPU: elastic state whose attributes are trees of ``DTensor``s.

Two gloo worlds commit at once, each into its own state directory
(``tests/torch_port_ckpt_util.py`` ``state_worker``): a 4-rank world at
dp=2 x tp=2 and a 2-rank world at pp=2, each ``STATE_COMMITS`` commits of
the small transformer's parameters and an Adam moment (wrapped by
``models.transformer.global_params``), an ``epoch`` and a per-rank
``note``, under ``HVTPU_CKPT_KEEP=2``.  Then each directory is synced by
a fresh state of zeros in the OTHER world (4 -> 2 and 2 -> 4):

* every rank's blocks of both attributes are bitwise the global arrays
  of the last commit, at the new layout;
* the plain attributes arrive through rank 0 (``note`` is rank 0's);
* only the newest two commits are kept, shards and replicated half;
* ``audit`` covers the replicated half only (the shards differ by rank,
  and an audit of them reports a divergence);
* a state without the array template refuses to sync with the
  reference's message, the class name changed.

Last, the reference's ``test_sharded_elastic_state_resync_across_
topologies`` in the port's terms: this process, a world of one, syncs the
2-rank world's commit onto its own layout.
"""

import os

import numpy as np
import pytest

from torch_port_ckpt_util import (
    STATE_COMMITS,
    STATE_KEEP,
    STATE_LAYOUTS,
    state_values,
    state_worker,
)
from torch_port_util import join_world, start_world
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

PAIRS = {4: 2, 2: 4}      # committing world -> syncing world


def _expected_blocks(world: int, rank: int) -> dict:
    """Rank ``rank``'s blocks of the last commit at ``world``'s layout, by
    the reference's specs sliced with numpy."""
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        flatten,
        param_specs,
    )
    from horovod_tpu_torch.parallel.mesh import MeshLayout
    from torch_port_ckpt_util import TFM_SMALL

    lay = STATE_LAYOUTS[world]
    sizes = {"pp": lay.get("pp", 1), "dp": lay.get("dp", 1),
             "tp": lay.get("tp", 1)}
    # rank -> coordinates, row-major over (pp, dp, tp)
    coord, r = {}, rank
    for axis in ("tp", "dp", "pp"):
        coord[axis], r = r % sizes[axis], r // sizes[axis]

    layout = MeshLayout(mesh=None, logical_to_physical={
        "dp": "dp", "tp": "tp", "pp": "pp", "sp": "tp", "ep": "dp"})
    specs = flatten(param_specs(TransformerConfig(**TFM_SMALL), layout))
    out = {}
    for attr, flat in state_values(STATE_COMMITS).items():
        for name, a in flat.items():
            index = []
            for dim, axis in enumerate(specs[name]):
                if axis is None:
                    index.append(slice(None))
                    continue
                size = a.shape[dim] // sizes[axis]
                index.append(slice(coord[axis] * size,
                                   (coord[axis] + 1) * size))
            out[f"{attr}/{name}"] = a[tuple(index)]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("sstate")
    dirs = {w: str(root / f"state_w{w}") for w in PAIRS}
    commits = {}
    for w in PAIRS:
        tmp = root / f"commit{w}"
        tmp.mkdir()
        commits[w] = (tmp, start_world(state_worker, w, tmp, dirs[w],
                                       "commit"))
    out = {"commit": {}, "sync": {}}
    for w, (tmp, handle) in commits.items():
        codes, infos = join_world(handle, timeout=180)
        assert codes == [0] * w, ("commit", w, codes)
        out["commit"][w] = infos
    syncs = {}
    for w, s in PAIRS.items():
        tmp = root / f"sync{s}"
        tmp.mkdir()
        syncs[s] = (tmp, start_world(state_worker, s, tmp, dirs[w], "sync"))
    for s, (tmp, handle) in syncs.items():
        codes, infos = join_world(handle, timeout=180)
        assert codes == [0] * s, ("sync", s, codes)
        out["sync"][s] = [(dict(np.load(tmp / f"state{r}.npz")), infos[r])
                          for r in range(s)]
    out["dirs"] = dirs
    return out


@pytest.mark.parametrize("saver", sorted(PAIRS))
def test_sync_reshards_onto_the_new_world(run, saver):
    world = PAIRS[saver]
    for rank, (arrays, info) in enumerate(run["sync"][world]):
        want = _expected_blocks(world, rank)
        assert arrays.keys() == want.keys()
        for key, a in want.items():
            assert arrays[key].dtype == a.dtype
            assert np.array_equal(arrays[key], a), (saver, world, rank, key)
        assert info["epoch"] == STATE_COMMITS


@pytest.mark.parametrize("saver", sorted(PAIRS))
def test_plain_attributes_arrive_through_rank_0(run, saver):
    for _, info in run["sync"][PAIRS[saver]]:
        assert info["note"] == "rank0"


@pytest.mark.parametrize("saver", sorted(PAIRS))
def test_keep_retains_the_newest_commits(run, saver):
    keep = list(range(STATE_COMMITS - STATE_KEEP + 1, STATE_COMMITS + 1))
    for info in run["commit"][saver]:
        assert info["snapshots"] == keep
        assert info["sharded_steps"] == [f"step_{s:012d}" for s in keep]


@pytest.mark.parametrize("saver", sorted(PAIRS))
def test_audit_covers_the_replicated_half_only(run, saver):
    for _, info in run["sync"][PAIRS[saver]]:
        assert info["audit_divergent"] == {}
        assert info["shards_divergent"] is True


@pytest.mark.parametrize("saver", sorted(PAIRS))
def test_missing_template_is_refused(run, saver):
    for _, info in run["sync"][PAIRS[saver]]:
        assert info["missing_template"] == (
            "ValueError: ShardedTorchState.sync: committed array attributes "
            "['exp_avg', 'params'] have no DTensor template in the "
            "restarted state; construct them (DTensor.from_local on the new "
            "mesh) before sync()")


def test_resync_across_topologies_like_the_reference(run, monkeypatch,
                                                    tmp_path):
    """The 2-rank world's commit synced in this process, a world of one
    over a layout of size 1 (the reference: 2 processes commit, the
    parent process resyncs on its own mesh)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from torch_port_ckpt_util import _state_attrs

    monkeypatch.setenv("HVTPU_ELASTIC_STATE_DIR", run["dirs"][2])
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    hvd.init(device="cpu")
    try:
        zeros = {a: {n: np.zeros_like(v) for n, v in flat.items()}
                 for a, flat in state_values(0).items()}
        _, _, attrs = _state_attrs(hvd, 1, zeros)
        state = hvd.elastic.ShardedTorchState(epoch=0, note="fresh",
                                              **attrs)
        state.sync()
        assert state.epoch == STATE_COMMITS and state.note == "rank0"
        for attr, flat in state_values(STATE_COMMITS).items():
            got = tfm.local_params(getattr(state, attr))
            for name, a in flat.items():
                assert np.array_equal(got[name].numpy(), a), (attr, name)
    finally:
        hvd.shutdown()
    assert os.path.isdir(run["dirs"][2])
