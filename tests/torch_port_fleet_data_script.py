"""The port's copy of ``tests/fleet_data_script.py``: a fleet job's
worker, the same exactly-once training loop, but DELIVER lines are
appended to the per-job file named by ``FLEET_DELIVER_LOG`` instead of
stdout — two jobs sharing one arbiter must not interleave their
accounting.  Single short O_APPEND writes keep concurrent ranks
line-atomic.

Started by the port's elastic driver under the fleet runner, on the CPU
(``HVTPU_CPU_DEVICES=1`` in the job's env, gloo).  Imports torch and the
port only.
"""

import os
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.data import ArraySource, ElasticDataLoader


def main():
    torch.set_num_threads(1)
    hvd.init()
    epochs = int(os.environ.get("ELASTIC_EPOCHS", "2"))
    sleep_s = float(os.environ.get("EPOCH_SLEEP", "0.3"))
    n = int(os.environ.get("DATA_SAMPLES", "48"))
    batch = int(os.environ.get("DATA_BATCH", "4"))
    log_path = os.environ["FLEET_DELIVER_LOG"]
    x = np.arange(n, dtype=np.float32).reshape(n, 1)
    loader = ElasticDataLoader(ArraySource({"x": x}), batch_size=batch,
                               seed=7)
    state = hvd.elastic.ObjectState(data=loader.state, total=0.0)

    def deliver(line):
        with open(log_path, "a") as f:
            f.write(line + "\n")

    @hvd.elastic.run
    def train(state):
        gen = os.environ.get("HVTPU_ELASTIC_GENERATION", "0")
        while loader.state.epoch < epochs:
            epoch = loader.state.epoch
            for b in loader:
                idx = sorted(int(v) for v in b["x"].ravel().tolist())
                out = hvd.allreduce(torch.ones(2), op=hvd.Sum)
                state.total += float(out[0])
                deliver(
                    f"DELIVER rank={hvd.rank()} size={hvd.size()} "
                    f"gen={gen} epoch={epoch} idx={idx}")
                time.sleep(sleep_s)
                state.commit()
        if hvd.rank() == 0:
            deliver(f"DONE size={hvd.size()} epoch={loader.state.epoch}")

    train(state)
    loader.close()
    hvd.shutdown()


if __name__ == "__main__":
    main()
