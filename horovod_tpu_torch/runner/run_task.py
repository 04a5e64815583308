"""Worker entry for the programmatic ``horovod_tpu_torch.runner.run()``
API (counterpart of ``horovod_tpu/runner/run_task.py``).

Parity surface: ``horovod/runner/__init__.py`` (``run``) +
``horovod/runner/task_fn.py`` — the launcher pickles the user function,
each rank unpickles and calls it, and per-rank return values are
pickled back for the launcher to collect.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

from . import secret


def _load(path: str):
    """Verify the HMAC before a single byte is unpickled (parity:
    secret.py-signed service messages — unverified pickle is code
    execution)."""
    with open(path, "rb") as f:
        signed = f.read()
    blob = secret.verify(secret.require_env_key(), signed)
    try:
        import cloudpickle

        return cloudpickle.loads(blob)
    except ImportError:
        return pickle.loads(blob)


def main(fn_path: str, out_dir: str) -> int:
    rank = int(os.environ.get("HVTPU_RANK", "0"))
    result_path = os.path.join(out_dir, f"rank_{rank}.pkl")
    try:
        fn, args, kwargs = _load(fn_path)
        result = fn(*args, **kwargs)
        payload = (True, result)
        code = 0
    except BaseException:
        payload = (False, traceback.format_exc())
        code = 1
    tmp = result_path + ".tmp"
    blob = pickle.dumps(payload)
    try:
        signed = secret.sign(secret.require_env_key(), blob)
    except secret.SignatureError:
        # no key (e.g. run_task invoked by hand): ship the failure
        # traceback unsigned — the launcher only accepts this when it
        # also has no key
        signed = blob
    with open(tmp, "wb") as f:
        f.write(signed)
    os.replace(tmp, result_path)
    try:
        from ..comm.stall import poisoned

        if poisoned():
            # The stall watchdog abandoned a pending collective: a
            # thread is parked inside it, so normal interpreter
            # teardown would hang.  Run the bounded shutdown first
            # (it aborts the NCCL communicators), then hard-exit with
            # the honest status — the result file is already durably
            # delivered.
            from ..core import state as _core_state

            try:
                _core_state.shutdown()
            except Exception:
                pass
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
    except ImportError:
        pass
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
