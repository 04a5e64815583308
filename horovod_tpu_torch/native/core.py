"""ctypes bindings to the port's C++ negotiation core (counterpart of
``horovod_tpu/native/core.py``).

The library is built from ``native/src`` by ``native/_build.py`` at
first use, into ``build/horovod_tpu_torch/``.  Unlike the JAX package,
a failed build or load raises (with the compiler's output); nothing
falls back quietly to the Python core.  ``HVTPU_FORCE_PY_CONTROLLER=1``
(read by ``make_controller``) is the way to that core.  The GP entry
points return None only where the C++ call declines (a singular Gram
matrix), never because the library is missing.

Parity surface: ``horovod/common/basics.py`` (``HorovodBasics`` loading
the native lib via ctypes) + the enqueue path of
``horovod/torch/mpi_ops_v2.cc``.
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import List, Optional, Sequence

from . import _build

ABI_VERSION = 5

_load_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[BaseException] = None


def build() -> str:
    """Compile the library if its sources changed; returns its path.
    Raises with the compiler's output on failure."""
    return str(_build.build())


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.hvt_abi_version.restype = c.c_int
    lib.hvt_controller_new.restype = c.c_void_p
    lib.hvt_controller_new.argtypes = [
        c.c_int, c.c_int, c.c_int64, c.c_int64, c.c_double, c.c_double,
    ]
    lib.hvt_controller_free.argtypes = [c.c_void_p]
    lib.hvt_controller_enqueue.restype = c.c_int
    lib.hvt_controller_enqueue.argtypes = [
        c.c_void_p, c.c_uint64, c.c_char_p, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_int64), c.c_int, c.c_int, c.c_int64, c.c_int,
    ]
    lib.hvt_controller_declare_group.argtypes = [c.c_void_p, c.c_int64, c.c_int]
    lib.hvt_controller_register_process_set.argtypes = [
        c.c_void_p, c.c_int, c.POINTER(c.c_int32), c.c_int,
    ]
    lib.hvt_controller_set_joined.argtypes = [c.c_void_p]
    lib.hvt_controller_set_tuned.argtypes = [
        c.c_void_p, c.c_int64, c.c_int32
    ]
    lib.hvt_controller_set_shutdown.argtypes = [c.c_void_p]
    lib.hvt_controller_set_resync_every.argtypes = [c.c_void_p, c.c_int64]
    lib.hvt_controller_force_resync.argtypes = [c.c_void_p]
    lib.hvt_controller_predict_responses.restype = c.c_int64
    lib.hvt_controller_predict_responses.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint32), c.c_int64,
        c.POINTER(c.c_uint8), c.c_int64,
    ]
    lib.hvt_controller_finish_names.restype = c.c_int64
    lib.hvt_controller_finish_names.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64,
        c.POINTER(c.c_uint64), c.c_int64,
    ]
    lib.hvt_controller_drain_requests.restype = c.c_int64
    lib.hvt_controller_drain_requests.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.c_int64, c.c_int64,
    ]
    lib.hvt_controller_ingest.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.c_int64,
    ]
    lib.hvt_controller_compute_responses.restype = c.c_int64
    lib.hvt_controller_compute_responses.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.c_int64,
    ]
    lib.hvt_controller_apply_responses.restype = c.c_int64
    lib.hvt_controller_apply_responses.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.c_int64,
        c.POINTER(c.c_uint64), c.c_int64,
    ]
    lib.hvt_controller_pending_count.restype = c.c_int64
    lib.hvt_controller_pending_count.argtypes = [c.c_void_p]
    lib.hvt_controller_pending_bytes.restype = c.c_int64
    lib.hvt_controller_pending_bytes.argtypes = [c.c_void_p]
    lib.hvt_controller_cache_size.restype = c.c_int64
    lib.hvt_controller_cache_size.argtypes = [c.c_void_p]
    lib.hvt_controller_set_fusion_threshold.argtypes = [c.c_void_p, c.c_int64]
    lib.hvt_controller_check_stalls.restype = c.c_int64
    lib.hvt_controller_check_stalls.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64,
    ]
    lib.hvt_parallel_gather.argtypes = [
        c.POINTER(c.c_uint8), c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.c_int64), c.c_int64,
    ]
    lib.hvt_parallel_scatter.argtypes = [
        c.POINTER(c.c_uint8), c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.c_int64), c.c_int64,
    ]
    lib.hvt_pool_num_threads.restype = c.c_int
    lib.hvt_timeline_new.restype = c.c_void_p
    lib.hvt_timeline_new.argtypes = [c.c_char_p, c.c_int]
    lib.hvt_timeline_free.argtypes = [c.c_void_p]
    lib.hvt_timeline_event.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char, c.c_char_p, c.c_double, c.c_double,
    ]
    lib.hvt_timeline_mark_cycle.argtypes = [c.c_void_p, c.c_double]
    lib.hvt_timeline_flush.argtypes = [c.c_void_p]
    lib.hvt_gp_predict.restype = c.c_int
    lib.hvt_gp_predict.argtypes = [
        c.POINTER(c.c_double), c.POINTER(c.c_double), c.c_int64, c.c_int64,
        c.POINTER(c.c_double), c.c_int64, c.c_double, c.c_double,
        c.c_double, c.POINTER(c.c_double), c.POINTER(c.c_double),
    ]
    lib.hvt_gp_expected_improvement.restype = c.c_int
    lib.hvt_gp_expected_improvement.argtypes = [
        c.POINTER(c.c_double), c.POINTER(c.c_double), c.c_int64, c.c_int64,
        c.POINTER(c.c_double), c.c_int64, c.c_double, c.c_double,
        c.c_double, c.c_double, c.c_double, c.POINTER(c.c_double),
    ]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, building it first if needed.  Raises when it
    cannot be built or loaded, or speaks another ABI; the first failure
    is kept and raised again."""
    global _lib, _lib_error
    with _load_lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise _lib_error
        try:
            path = build()
            lib = _configure(ctypes.CDLL(path))
            if lib.hvt_abi_version() != ABI_VERSION:
                raise RuntimeError(
                    f"{path} speaks ABI {lib.hvt_abi_version()}, not "
                    f"{ABI_VERSION}; set {_build.FORCE_PY}=1 to run the "
                    "Python core instead")
        except (OSError, AttributeError) as e:
            _lib_error = RuntimeError(
                f"the native negotiation core failed to load: {e}; set "
                f"{_build.FORCE_PY}=1 to run the Python core instead")
            raise _lib_error from e
        except RuntimeError as e:
            _lib_error = e
            raise
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads (``--check-build``)."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _as_u8(buf: bytearray) -> "ctypes.POINTER(ctypes.c_uint8)":
    return (ctypes.c_uint8 * len(buf)).from_buffer(buf)


class NativeController:
    """Thin OO wrapper over the C controller (see fallback.PyController
    for the Python twin with identical semantics)."""

    def __init__(self, rank: int, size: int, fusion_threshold: int,
                 cache_capacity: int = 1024, stall_warn_s: float = 60.0,
                 stall_abort_s: float = 0.0, resync_every: int = 64):
        lib = load()
        self._lib = lib
        self._ptr = lib.hvt_controller_new(
            rank, size, fusion_threshold, cache_capacity,
            stall_warn_s, stall_abort_s,
        )
        self.rank = rank
        self.size = size
        self.fusion_threshold = fusion_threshold
        self.resync_every = resync_every
        if resync_every != 64:
            lib.hvt_controller_set_resync_every(self._ptr, resync_every)

    def close(self):
        if self._ptr:
            self._lib.hvt_controller_free(self._ptr)
            self._ptr = None

    def _live(self) -> int:
        # a closed handle must not reach C (a use after free)
        if not self._ptr:
            raise RuntimeError("the native controller is closed")
        return self._ptr

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def enqueue(self, seq: int, name: str, op_type: int, red_op: int,
                dtype: int, shape: Sequence[int], process_set_id: int = 0,
                group_id: int = -1, root_rank: int = -1) -> bool:
        arr = (ctypes.c_int64 * len(shape))(*shape)
        rc = self._lib.hvt_controller_enqueue(
            self._live(), seq, name.encode(), op_type, red_op, dtype,
            arr, len(shape), process_set_id, group_id, root_rank,
        )
        return rc == 0

    def declare_group(self, group_id: int, size: int):
        self._lib.hvt_controller_declare_group(self._live(), group_id, size)

    def register_process_set(self, psid: int, ranks: Sequence[int]):
        arr = (ctypes.c_int32 * len(ranks))(*ranks)
        self._lib.hvt_controller_register_process_set(
            self._live(), psid, arr, len(ranks)
        )

    def set_joined(self):
        self._lib.hvt_controller_set_joined(self._live())

    def _blob_call(self, fn) -> bytes:
        n = fn(self._live(), None, 0)
        if n == 0:
            return b""
        buf = bytearray(n)
        fn(self._live(), _as_u8(buf), n)
        return bytes(buf)

    def drain_requests(self, limit: int = 0) -> bytes:
        """limit > 0 caps the drained entries at the caller's known
        steady burst size (atomic-burst cap; 0 = drain everything)."""
        fn = self._lib.hvt_controller_drain_requests
        n = fn(self._live(), None, 0, limit)
        if n == 0:
            return b""
        buf = bytearray(n)
        fn(self._live(), _as_u8(buf), n, limit)
        return bytes(buf)

    def ingest(self, blob: bytes):
        buf = bytearray(blob)
        self._lib.hvt_controller_ingest(self._live(), _as_u8(buf), len(blob))

    def compute_responses(self) -> bytes:
        return self._blob_call(self._lib.hvt_controller_compute_responses)

    def apply_responses(self, blob: bytes, max_finished: int = 65536
                        ) -> List[int]:
        buf = bytearray(blob)
        out = (ctypes.c_uint64 * max_finished)()
        n = self._lib.hvt_controller_apply_responses(
            self._live(), _as_u8(buf), len(blob), out, max_finished
        )
        return list(out[: min(n, max_finished)])

    @property
    def pending_count(self) -> int:
        return self._lib.hvt_controller_pending_count(self._live())

    @property
    def pending_bytes(self) -> int:
        return self._lib.hvt_controller_pending_bytes(self._live())

    @property
    def cache_size(self) -> int:
        return self._lib.hvt_controller_cache_size(self._live())

    def set_fusion_threshold(self, nbytes: int):
        self.fusion_threshold = nbytes
        self._lib.hvt_controller_set_fusion_threshold(self._live(), nbytes)

    def set_tuned(self, fusion_threshold: int, cycle_time_us: int):
        """Publish autotuned params in subsequent ResponseLists
        (coordinator only; parity: ParameterManager broadcast)."""
        self._lib.hvt_controller_set_tuned(
            self._live(), fusion_threshold, cycle_time_us
        )

    def set_shutdown(self):
        """Announce this rank wants to shut down (next DrainRequests)."""
        self._lib.hvt_controller_set_shutdown(self._live())

    def set_resync_every(self, n: int):
        """Bypass cadence: every Nth all-cache-hit cycle sends a full
        resync blob (0 disables the bypass fast path entirely)."""
        self.resync_every = int(n)
        self._lib.hvt_controller_set_resync_every(self._live(), int(n))

    def force_resync(self):
        """Rank-side re-anchor (mispredict recovery / quiesce rollback):
        the next drain_requests emits a full-entry resync frame exactly
        as if the coordinator had requested cache_resync_needed."""
        self._lib.hvt_controller_force_resync(self._live())

    def predict_responses(self, bits: Sequence[int]) -> Optional[bytes]:
        """Predicted steady-state ResponseList for a pure bypass cycle
        of exactly ``bits`` (see fallback.PyController); None when a
        bit is unknown."""
        arr = (ctypes.c_uint32 * len(bits))(*bits)
        n = self._lib.hvt_controller_predict_responses(
            self._live(), arr, len(bits), None, 0)
        if n == 0:
            return None
        buf = bytearray(n)
        self._lib.hvt_controller_predict_responses(
            self._live(), arr, len(bits), _as_u8(buf), n)
        return bytes(buf)

    def finish(self, names: Sequence[str],
               max_finished: int = 65536) -> List[int]:
        """Eagerly retire predicted-executed in-flight entries."""
        joined = "\n".join(names).encode()
        out = (ctypes.c_uint64 * max_finished)()
        n = self._lib.hvt_controller_finish_names(
            self._live(), joined, len(joined), out, max_finished)
        return list(out[: min(n, max_finished)])

    def check_stalls(self) -> List[dict]:
        n = int(self._lib.hvt_controller_check_stalls(self._live(), None, 0))
        buf = ctypes.create_string_buffer(n + 1)
        self._lib.hvt_controller_check_stalls(self._live(), buf, n + 1)
        return json.loads(buf.raw[:n].decode())


class NativeTimeline:
    """Chrome-trace writer backed by native/src/timeline.cc."""

    def __init__(self, path: str, rank: int):
        lib = load()
        self._lib = lib
        self._ptr = lib.hvt_timeline_new(path.encode(), rank)
        if not self._ptr:
            raise OSError(f"cannot open timeline file: {path}")

    def event(self, name: str, ph: str, category: str, ts_us: float,
              dur_us: float = 0.0):
        self._lib.hvt_timeline_event(
            self._ptr, name.encode(), ph.encode(), category.encode(),
            ts_us, dur_us,
        )

    def mark_cycle(self, ts_us: float):
        self._lib.hvt_timeline_mark_cycle(self._ptr, ts_us)

    def flush(self):
        self._lib.hvt_timeline_flush(self._ptr)

    def close(self):
        if self._ptr:
            self._lib.hvt_timeline_free(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def parallel_gather(dst: memoryview, srcs: List[memoryview]) -> None:
    """Pack many buffers into one flat staging buffer using the native
    thread pool (parity: MemcpyInFusionBuffer + thread_pool.cc)."""
    lib = load()
    n = len(srcs)
    if n == 0:
        return
    sizes = (ctypes.c_int64 * n)(*[len(s) for s in srcs])
    dst_arr = (ctypes.c_uint8 * len(dst)).from_buffer(dst)
    src_ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    keep = []
    for i, s in enumerate(srcs):
        a = (ctypes.c_uint8 * len(s)).from_buffer(s if not s.readonly
                                                  else bytearray(s))
        keep.append(a)
        src_ptrs[i] = ctypes.cast(a, ctypes.POINTER(ctypes.c_uint8))
    lib.hvt_parallel_gather(dst_arr, src_ptrs, sizes, n)


def parallel_scatter(src: memoryview, dsts: List[memoryview]) -> None:
    """Unpack one flat buffer into many (parity: MemcpyOutFusionBuffer)."""
    lib = load()
    n = len(dsts)
    if n == 0:
        return
    sizes = (ctypes.c_int64 * n)(*[len(d) for d in dsts])
    src_buf = bytearray(src) if src.readonly else src
    src_arr = (ctypes.c_uint8 * len(src)).from_buffer(src_buf)
    dst_ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    keep = []
    for i, d in enumerate(dsts):
        a = (ctypes.c_uint8 * len(d)).from_buffer(d)
        keep.append(a)
        dst_ptrs[i] = ctypes.cast(a, ctypes.POINTER(ctypes.c_uint8))
    lib.hvt_parallel_scatter(src_arr, dst_ptrs, sizes, n)


def _as_c_doubles(arr):
    import numpy as np

    a = np.ascontiguousarray(arr, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def gp_predict(xs, ys, cand, *, length_scale: float, noise: float,
               signal_variance: float):
    """Native GP posterior (mu, sigma) at ``cand`` (parity:
    gaussian_process.cc GaussianProcessRegressor).  Returns None when
    the Gram matrix is singular — the caller falls back to the numpy
    twin; raises when the library cannot be loaded."""
    import numpy as np

    lib = load()
    xs_np, xs_p = _as_c_doubles(np.atleast_2d(xs))
    ys_np, ys_p = _as_c_doubles(np.asarray(ys).reshape(-1))
    cand_np, cand_p = _as_c_doubles(np.atleast_2d(cand))
    n, d = xs_np.shape
    m = cand_np.shape[0]
    # shape discipline before raw pointers cross the C boundary: a
    # mismatch would stride wrongly (silent garbage) or read OOB; the
    # numpy twin raises, so raise here too
    if cand_np.shape[1] != d or ys_np.shape[0] != n:
        raise ValueError(
            f"gp_predict shape mismatch: xs {xs_np.shape}, "
            f"ys {ys_np.shape}, cand {cand_np.shape}"
        )
    mu = np.empty(m, np.float64)
    sigma = np.empty(m, np.float64)
    rc = lib.hvt_gp_predict(
        xs_p, ys_p, n, d, cand_p, m,
        ctypes.c_double(length_scale), ctypes.c_double(noise),
        ctypes.c_double(signal_variance),
        mu.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sigma.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        return None
    return mu, sigma


def gp_expected_improvement(xs, ys, cand, *, length_scale: float,
                            noise: float, signal_variance: float,
                            best_y: float, xi: float):
    """Native fit+predict+EI in one call (parity: the EI loop of
    bayesian_optimization.cc NextSample).  None (a singular Gram
    matrix) -> the caller falls back to the numpy twin."""
    import numpy as np

    lib = load()
    xs_np, xs_p = _as_c_doubles(np.atleast_2d(xs))
    ys_np, ys_p = _as_c_doubles(np.asarray(ys).reshape(-1))
    cand_np, cand_p = _as_c_doubles(np.atleast_2d(cand))
    n, d = xs_np.shape
    m = cand_np.shape[0]
    if cand_np.shape[1] != d or ys_np.shape[0] != n:
        raise ValueError(
            f"gp_expected_improvement shape mismatch: xs {xs_np.shape}, "
            f"ys {ys_np.shape}, cand {cand_np.shape}"
        )
    ei = np.empty(m, np.float64)
    rc = lib.hvt_gp_expected_improvement(
        xs_p, ys_p, n, d, cand_p, m,
        ctypes.c_double(length_scale), ctypes.c_double(noise),
        ctypes.c_double(signal_variance), ctypes.c_double(best_y),
        ctypes.c_double(xi),
        ei.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        return None
    return ei
