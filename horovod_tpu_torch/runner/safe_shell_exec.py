"""Subprocess execution with output piping and reliable termination.

Parity surface: ``horovod/runner/common/util/safe_shell_exec.py``
(``execute``, ``forward_stream``, GRACEFUL_TERMINATION_TIME) — fork the
worker, pump its stdout/stderr line-by-line through prefixing filters,
terminate the whole process group on failure/timeout.  The port's copy
of ``horovod_tpu/runner/safe_shell_exec.py``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

GRACEFUL_TERMINATION_TIME_S = 5.0


def term_grace_s() -> float:
    """Seconds between SIGTERM and the SIGKILL escalation when the
    launcher terminates a worker (HVTPU_TERM_GRACE_SECONDS, default 5).

    Raise it together with HVTPU_DRAIN_GRACE_SECONDS: a worker handed a
    preemption notice (core/preempt.py) needs the kill grace to at
    least cover the drain grace, or the escalation SIGKILL lands
    mid-drain-commit and downgrades a planned departure to a crash.
    Read per call so tests and long-lived drivers pick up changes."""
    raw = os.environ.get("HVTPU_TERM_GRACE_SECONDS")
    if not raw:
        return GRACEFUL_TERMINATION_TIME_S
    try:
        val = float(raw)
    except ValueError:
        return GRACEFUL_TERMINATION_TIME_S
    return val if val > 0 else GRACEFUL_TERMINATION_TIME_S


def _pump(stream, sink, prefix: str, lock: threading.Lock):
    """Forward ``stream`` to ``sink`` line-by-line with a rank prefix
    (parity: the '[1]<stdout>:' piping threads of launch_gloo)."""
    try:
        for raw in iter(stream.readline, b""):
            line = raw.decode("utf-8", errors="replace")
            with lock:
                sink.write(f"{prefix}{line}")
                sink.flush()
    finally:
        stream.close()


class WorkerProcess:
    """A launched worker with its output-pump threads."""

    def __init__(
        self,
        rank: int,
        command: Sequence[str],
        env: Dict[str, str],
        prefix_output: bool = True,
        output_dir: Optional[str] = None,
        stdout_lock: Optional[threading.Lock] = None,
    ):
        self.rank = rank
        self._files: List = []
        if output_dir is not None:
            # Parity: horovodrun --output-filename — per-rank files
            # <dir>/<rank>/{stdout,stderr}.
            rank_dir = os.path.join(output_dir, str(rank))
            os.makedirs(rank_dir, exist_ok=True)
            out_f = open(os.path.join(rank_dir, "stdout"), "wb")
            err_f = open(os.path.join(rank_dir, "stderr"), "wb")
            self._files = [out_f, err_f]
            stdout_dst, stderr_dst = out_f, err_f
            pump = False
        else:
            stdout_dst, stderr_dst = subprocess.PIPE, subprocess.PIPE
            pump = True
        self.proc = subprocess.Popen(
            list(command),
            env=env,
            stdout=stdout_dst,
            stderr=stderr_dst,
            start_new_session=True,  # own process group for clean kill
        )
        self._threads: List[threading.Thread] = []
        if pump:
            lock = stdout_lock or threading.Lock()
            p_out = f"[{rank}]<stdout>:" if prefix_output else ""
            p_err = f"[{rank}]<stderr>:" if prefix_output else ""
            for stream, sink, prefix in (
                (self.proc.stdout, sys.stdout, p_out),
                (self.proc.stderr, sys.stderr, p_err),
            ):
                t = threading.Thread(
                    target=_pump, args=(stream, sink, prefix, lock),
                    daemon=True,
                )
                t.start()
                self._threads.append(t)

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def wait(self, timeout: Optional[float] = None) -> int:
        code = self.proc.wait(timeout)
        self.join_pumps()
        return code

    def join_pumps(self):
        for t in self._threads:
            t.join(timeout=5)
        for f in self._files:
            try:
                f.close()
            except Exception:
                pass

    def terminate(self, grace_s: Optional[float] = None):
        """SIGTERM the worker's process group, escalate to SIGKILL after
        the graceful window (parity: safe_shell_exec terminate path).
        ``grace_s`` overrides HVTPU_TERM_GRACE_SECONDS for one call —
        the elastic driver passes its drain grace so a draining worker
        is never killed before its drain window expires."""
        if self.proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        if grace_s is None:
            grace_s = term_grace_s()
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                return
            time.sleep(0.1)
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def wait_for_any_failure_or_all_done(
    workers: List[WorkerProcess],
    timeout: Optional[float] = None,
    poll_interval: float = 0.1,
    on_failure: Optional[Callable[[WorkerProcess, int], None]] = None,
) -> int:
    """Wait until every worker exits 0, or any exits non-zero (then
    terminate the rest).  Returns the overall exit code.

    Parity: the reference launcher's behavior — one failed rank takes
    the whole job down with its exit code.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    pending = {w.rank: w for w in workers}
    exit_code = 0
    failed: Optional[WorkerProcess] = None
    while pending:
        for rank in list(pending):
            w = pending[rank]
            code = w.poll()
            if code is None:
                continue
            del pending[rank]
            if code != 0 and exit_code == 0:
                exit_code = code
                failed = w
                if on_failure is not None:
                    on_failure(w, code)
        if failed is not None:
            break
        if deadline is not None and time.monotonic() > deadline:
            exit_code = 124  # shell timeout convention
            break
        if pending:
            time.sleep(poll_interval)
    for w in pending.values():
        w.terminate()
    for w in workers:
        try:
            w.proc.wait(timeout=term_grace_s() * 2)
        except subprocess.TimeoutExpired:
            pass
        w.join_pumps()
    return exit_code
