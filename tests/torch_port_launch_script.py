"""Worker script of the port's launched worlds
(``tests/test_torch_port_launch.py``), started by the port's launcher::

    python -m horovod_tpu_torch.runner -np 2 --cpu-devices 1 -- \\
        python tests/torch_port_launch_script.py resnet OUT_DIR

Modes:

* ``resnet``: ``torch_port_util.two_rank_step`` at predivide 2.0, after
  an ``init()`` that rendezvouses on the launcher's coordinator;
* ``hier``: the checks of a 4-rank world on ``localhost:2,127.0.0.1:2``
  under ``HVTPU_HIERARCHICAL_ALLREDUCE=1`` (topology, hierarchical Sum,
  Average and Adasum, the flat cases, one optimizer step, one Average
  bucket of every gradient), saved in
  ``OUT_DIR/rank<r>.npz``;
* ``fail``: rank 1 exits 3 at once, the others sleep.

Imports torch and the port only."""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import torch_port_util as u  # noqa: E402

HIER_N = 1000
HIER_PREDIVIDE = 2.0


def hier_inputs(rank: int) -> dict:
    """Rank ``rank``'s inputs of the ``hier`` mode, from a seed; the test
    makes the same arrays for its references."""
    rng = np.random.RandomState(60 + rank)
    return {"f": rng.randn(HIER_N).astype(np.float32),
            "i": rng.randint(-50, 50, size=(37,)).astype(np.int32)}


def _hier(out_dir: str) -> None:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.comm import eager
    from horovod_tpu_torch.comm.reduce_ops import ReduceOp
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.core.process_set import global_process_set
    from horovod_tpu_torch.core.topology import hierarchical_layout

    hvd.init()
    rank = hvd.rank()
    inp = hier_inputs(rank)
    f, i = torch.from_numpy(inp["f"]), torch.from_numpy(inp["i"])

    def routed(op, dtype) -> bool:
        return eager.hierarchical_groups(global_process_set, op,
                                         dtype) is not None

    res = {
        "topology": np.array([hvd.rank(), hvd.size(), hvd.local_rank(),
                              hvd.local_size(), hvd.cross_rank(),
                              hvd.cross_size(), int(hvd.is_homogeneous())]),
        "routes": np.array([routed(ReduceOp.SUM, torch.float32),
                            routed(ReduceOp.AVERAGE, torch.float32),
                            routed(ReduceOp.ADASUM, torch.float32),
                            routed(ReduceOp.AVERAGE, torch.int32)]),
        "sum": hvd.allreduce(f, op=hvd.Sum).numpy(),
        "avg": hvd.allreduce(f, op=hvd.Average).numpy(),
        "adasum": hvd.allreduce(f, op=hvd.Adasum).numpy(),
        "int_avg": hvd.allreduce(i, op=hvd.Average).numpy(),
    }
    # the flat route: no topology, as init() leaves it with the flag
    # off; then what init() decides for a layout the launcher did not
    # certify uniform, with the flag on
    st = core_state.global_state()
    topology, st.topology = st.topology, None
    res["flat_sum"] = hvd.allreduce(f, op=hvd.Sum).numpy()
    res["flat_int_avg"] = hvd.allreduce(i, op=hvd.Average).numpy()
    uncertified = dataclasses.replace(st.config, uniform_local_size=0)
    if hierarchical_layout(uncertified, st.size, st.local_size,
                           st.cross_size):
        st.topology = topology
    res["nonuniform_routed"] = np.array(routed(ReduceOp.SUM, torch.float32))
    res["nonuniform_sum"] = hvd.allreduce(f, op=hvd.Sum).numpy()
    st.topology = topology

    # one optimizer step under the flag: the buckets' two stages
    model = u.narrow_resnet(seed=100 + rank)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        gradient_predivide_factor=HIER_PREDIVIDE)
    rng = np.random.RandomState(rank)
    x = torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, size=(4,)))
    opt.zero_grad()
    F.cross_entropy(model(x), y).backward()
    for n, p in model.named_parameters():
        res[f"local/{n}"] = p.grad.detach().clone().numpy()
    opt.synchronize()
    for n, p in model.named_parameters():
        res[f"reduced/{n}"] = p.grad.detach().clone().numpy()
    res["bucket_sizes"] = np.array([len(b) for b in opt.buckets])
    # one bucket of every gradient under Average: the local stage's
    # divide between the two stages
    from horovod_tpu_torch.comm.compression import NoneCompressor
    from horovod_tpu_torch.torch.optimizer import GroupReduction

    names = [n for n, _ in model.named_parameters()]
    avg = GroupReduction(ReduceOp.AVERAGE, 1.0, 1.0, NoneCompressor,
                         global_process_set).reduce(
        [torch.from_numpy(res[f"local/{n}"]) for n in names])
    for n, t in zip(names, avg):
        res[f"bucket_avg/{n}"] = t.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    hvd.shutdown()


def main(mode: str, out_dir: str) -> int:
    torch.set_num_threads(1)
    if mode == "resnet":
        import horovod_tpu_torch as hvd

        hvd.init()
        u.two_rank_step(hvd, hvd.rank(), out_dir, predivide=2.0)
        hvd.shutdown()
    elif mode == "hier":
        _hier(out_dir)
    elif mode == "fail":
        if os.environ["HVTPU_RANK"] == "1":
            return 3
        with open(os.path.join(out_dir, "survivor.pid"), "w") as fh:
            fh.write(str(os.getpid()))
        time.sleep(120)
    else:
        raise ValueError(mode)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
