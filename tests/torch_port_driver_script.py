"""Worker script of the port's elastic driver tests
(``tests/test_torch_port_driver.py``), started by the port's launcher
with ``--host-discovery-script``::

    python -m horovod_tpu_torch.runner --host-discovery-script D \\
        --cpu-devices 1 -- python tests/torch_port_driver_script.py MODE

The driver gives every incarnation the same env, so an incarnation picks
its interruption by ``HVTPU_ELASTIC_GENERATION``.

* ``elastic``: ``torch_port_util.elastic_incarnation`` (the narrow
  ResNet's elastic run) with the env of ``HVT_PLAN`` (JSON: generation
  -> env) added for this generation, e.g. a kill fault in generation 0;
* ``resize``: a small linear model, one JSON line a step in
  ``HVT_LOG`` (generation, rank, world size, step); in generation 0 rank
  0 rewrites the discovery script's hosts file (``HVT_HOSTS_FILE``) to
  ``localhost:1`` after its second commit, and the ranks reset when the
  driver signals the change.

Imports torch and the port only."""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import torch_port_util as u  # noqa: E402

RESIZE_STEPS = 8


def _resize() -> None:
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init()
    gen = int(os.environ["HVTPU_ELASTIC_GENERATION"])
    model = torch.nn.Linear(6, 3)
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        model.weight.copy_(torch.randn(3, 6, generator=g))
        model.bias.zero_()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model, opt, step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < RESIZE_STEPS:
            g = torch.Generator().manual_seed(1000 * state.step + hvd.rank())
            x = torch.randn(4, 6, generator=g)
            y = torch.randint(0, 3, (4,), generator=g)
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            opt.step()
            state.step += 1
            u._log(os.environ["HVT_LOG"],
                   {"gen": gen, "rank": hvd.rank(), "size": hvd.size(),
                    "step": state.step})
            if gen == 0 and hvd.rank() == 0 and state.step == 2:
                with open(os.environ["HVT_HOSTS_FILE"], "w") as f:
                    f.write("localhost:1\n")
            time.sleep(0.3)
            state.commit()

    train(state)
    hvd.shutdown()


def main(mode: str) -> int:
    if mode == "elastic":
        plan = json.loads(os.environ.get("HVT_PLAN", "{}"))
        os.environ.update(plan.get(os.environ["HVTPU_ELASTIC_GENERATION"],
                                   {}))
        u.elastic_incarnation()
    elif mode == "resize":
        _resize()
    else:
        raise ValueError(mode)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
