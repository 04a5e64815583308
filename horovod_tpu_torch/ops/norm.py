"""``TpuBatchNorm``'s statistics, normalize, ReLU and residual add as
hand-written CUDA kernels (``csrc/norm.cu``), two forward and two
backward, under one ``torch.autograd.Function``.

:func:`fused_norm` computes, over dim 1 of an NCHW tensor ``x``::

    y = relu?(R(r + R(R(x * a) + b)))

``R`` rounding to the compute dtype, ``r`` the residual (where one is
given), ``a = R(scale * rsqrt(var + eps))`` and ``b = R(bias - mean *
scale * rsqrt(var + eps))`` from float32 statistics over the ``(N*H*W,
C)`` view: the mean and the mean of squares, the biased variance
``max(E[x^2] - mean^2, 0)``; in eval the running stats.  With
``axis_name`` the moments (not the variances) are averaged over that
mesh axis by ``parallel/_collectives.pmean`` between the statistics and
the rest, and the backward's two per-channel moment gradients by its
adjoint, ``pmean`` again.  The running stats follow flax: ``ra = m * ra +
(1 - m) * stat``, written in training where ``update_running`` is true.

On a CPU (or meta) tensor it computes :func:`batch_norm_plain`, the eager
composition ``TpuBatchNorm`` has always run, then ``F.relu(r + y)`` or
``F.relu(y)``.  On a CUDA tensor it launches the kernels on the current
stream, counted in ``fused_norm.launches``: training, ``norm_stats`` and
``norm_apply`` forward (a third, ``norm_finalize``, after the moments'
``pmean`` of a synchronized norm; eval ``norm_finalize`` and
``norm_apply``), ``norm_grad_reduce`` and ``norm_grad_input`` backward.
There is no other path: a CUDA tensor the kernels do not take raises.

The backward is :func:`grad_closed_form`'s: ``dx = a * g + c0 + c1 * x``
with per-channel float32 ``c0``, ``c1``, ``g`` the output gradient masked
by the ReLU, computed in float32 and rounded once.  It saves ``x`` (in its
own dtype), the output where a residual was added (the ReLU mask; the
next layer saves it too) and per-channel float32 vectors: no float32 copy
of an activation.  Every reduction is in a fixed order, so the same
inputs give the same bits (``remat``'s recomputation, the ranks'
digests).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

THREADS = 256          # a CTA (csrc/norm.cu kThreads)
GROUP = 16             # chunks a first-level sum takes (kGroup)
TILE_VECTORS = 8       # most threads (vectors) on one row of a tile
COUNTERS = 4096        # the arrival counters a stream holds
# the kernels, as hvtpu_norm_ctas_per_sm names them
STATS, APPLY, GRAD_REDUCE, GRAD_INPUT = 0, 1, 2, 3
STAT_ROWS = ("a", "b", "mean", "rstd", "inv", "scale", "pass")
GRAD_ROWS = ("dscale", "dbias", "dmean", "dmean_sq")
MASK_NONE, MASK_RECOMPUTE, MASK_SAVED = 0, 1, 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _f32(v: float) -> float:
    return ctypes.c_float(float(v)).value


# -- the plain version ----------------------------------------------------------

def batch_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, mean_buf: torch.Tensor,
                     var_buf: torch.Tensor, *, training: bool,
                     update_running: bool, momentum: float, epsilon: float,
                     dtype: torch.dtype,
                     residual: Optional[torch.Tensor] = None,
                     relu: bool = False, axis_name=None,
                     mesh=None) -> torch.Tensor:
    """The eager composition: float32 statistics, ``x * a + b`` in the
    compute dtype, then the epilogue ``F.relu(residual + y)`` /
    ``F.relu(y)`` / ``residual + y``."""
    c = x.shape[1]
    if training:
        x2 = x.permute(0, 2, 3, 1).reshape(-1, c)
        mean = x2.mean(dim=0, dtype=torch.float32)
        mean_sq = x2.float().square().mean(dim=0)
        if axis_name is not None:
            from ..parallel._collectives import pmean

            mean = pmean(mean, axis_name, mesh=mesh)
            mean_sq = pmean(mean_sq, axis_name, mesh=mesh)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        if update_running:
            with torch.no_grad():
                m = momentum
                mean_buf.copy_(m * mean_buf + (1.0 - m) * mean)
                var_buf.copy_(m * var_buf + (1.0 - m) * var)
    else:
        mean, var = mean_buf, var_buf
    inv = torch.rsqrt(var + epsilon) * scale
    shift = -mean * inv + bias
    a = inv.to(dtype).view(1, c, 1, 1)
    b = shift.to(dtype).view(1, c, 1, 1)
    y = (x * a + b).to(dtype)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


def grad_closed_form(x: torch.Tensor, dy: torch.Tensor,
                     relu_src: Optional[torch.Tensor], a: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor,
                     var_raw: torch.Tensor, scale: torch.Tensor,
                     epsilon: float, *, training: bool):
    """The backward the kernels compute, in plain torch at the inputs'
    precision, over channels-last ``(M, C)`` rows: ``(dx, dscale, dbias,
    g, c0, c1)``, ``g`` also the residual's gradient.

    ``x``, ``dy`` are ``(M, C)``; ``relu_src`` is where a ReLU follows the
    value whose sign masks it: the output where a residual was added,
    ``R(R(x * a) + b)`` where none was (the kernels recompute it), None
    where no ReLU follows.  ``a`` is the rounded scale factor, ``mean`` and
    ``var`` the statistics the forward used, ``var_raw`` ``E[x^2] -
    mean^2`` before the clamp (training).  ``g`` is ``dy`` zeroed where
    ``relu_src <= 0``; then, per channel::

        dinv   = sum(g x) - mean sum(g)      (a takes sum g x, b sum g)
        dscale = dinv rstd,   dbias = sum(g)
        dvar   = -dinv scale rstd^3 / 2 where var_raw >= 0, else 0
        c0     = (-inv sum(g) - 2 mean dvar) / M
        c1     = 2 dvar / M                  (training; else both 0)
        dx     = a g + c0 + c1 x

    ``rstd = rsqrt(var + eps)``, ``inv = scale rstd``.  A synchronized
    norm averages ``c0 M`` and ``c1 M / 2`` over the axis first.
    """
    m = x.shape[0]
    g = dy if relu_src is None else torch.where(
        relu_src <= 0, torch.zeros_like(dy), dy)
    sg, sgx = g.sum(0), (g * x).sum(0)
    rstd = torch.rsqrt(var + epsilon)
    dinv = sgx - mean * sg
    dscale, dbias = dinv * rstd, sg
    if training:
        dvar = torch.where(var_raw >= 0, -0.5 * dinv * scale * rstd ** 3,
                           torch.zeros_like(dinv))
        c0 = (-(scale * rstd) * sg - 2 * mean * dvar) / m
        c1 = 2 * dvar / m
    else:
        c0 = c1 = torch.zeros_like(sg)
    dx = a * g + c0 + c1 * x
    return dx, dscale, dbias, g, c0, c1


# -- the launch plan ------------------------------------------------------------

class Plan(NamedTuple):
    """A launch's grid over the ``(rows, channels)`` view: ``tiles``
    channel tiles of ``tpr`` threads a row (one vector each), ``rpi`` rows
    an iteration, ``chunks`` row chunks of ``chunk_rows`` rows."""
    rows: int
    channels: int
    tpr: int
    tiles: int
    rpi: int
    chunks: int
    chunk_rows: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(rows: int, channels: int, vec: int, ctas: int) -> Plan:
    """The grid for ``rows x channels`` at ``vec`` elements a thread, for
    a kernel of which the card holds ``ctas`` CTAs at once: channel tiles
    of at most ``TILE_VECTORS`` vectors, as even as they come in whole
    sectors (an even count of vectors where a row takes several), and row
    chunks (whole iterations) to one wave of CTAs, fewer where the rows
    run out."""
    vectors = channels // vec
    tiles = _cdiv(vectors, TILE_VECTORS)
    tpr = _cdiv(vectors, tiles)
    if tiles > 1:
        tpr += tpr % 2      # tiles of whole 32-byte sectors
    rpi = THREADS // tpr
    chunks = max(1, min(ctas // tiles, _cdiv(rows, rpi)))
    chunk_rows = _cdiv(_cdiv(rows, chunks), rpi) * rpi
    return Plan(rows, channels, tpr, tiles, rpi, _cdiv(rows, chunk_rows),
                chunk_rows)


def partial_rows(p: Plan) -> int:
    """Rows of (sum, sum) partials a reduction kernel takes: one a chunk,
    then one a group of ``GROUP`` chunks."""
    return p.chunks + _cdiv(p.chunks, GROUP)


@functools.lru_cache(maxsize=4096)
def _plan_array(rows: int, channels: int, vec: int, ctas: int):
    p = plan(rows, channels, vec, ctas)
    if p.tiles * (_cdiv(p.chunks, GROUP) + 1) > COUNTERS:
        raise ValueError(f"fused_norm: {channels} channels need more than "
                         f"{COUNTERS} arrival counters")
    return p, np.asarray(p, dtype=np.int64)


def vector_width(channels: int, dtype: torch.dtype) -> int:
    """Elements a thread moves at once: a 16-byte vector where a row of
    ``channels`` is whole vectors, else one (rows that are not a multiple
    of 16 bytes leave every other row's vectors unaligned)."""
    full = 16 // dtype.itemsize
    return full if channels % full == 0 else 1


# -- the library ----------------------------------------------------------------

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("norm")
    for name, args in (
            ("hvtpu_norm_stats", [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _F, _F, _F, _I, _I, _P]),
            ("hvtpu_norm_finalize", [_I, _I64, _P, _P, _P, _P, _P, _P, _F,
                                     _F, _F, _I, _P]),
            ("hvtpu_norm_apply", [_I, _I, _P, _P, _P, _P, _P, _I, _P]),
            ("hvtpu_norm_grad_reduce", [_I, _I, _P, _I, _P, _P, _P, _P, _P,
                                        _P, _P, _I, _P]),
            ("hvtpu_norm_grad_input", [_I, _I, _P, _I, _P, _P, _P, _P, _P,
                                       _P, _P, _I, _P]),
            ("hvtpu_norm_ctas_per_sm", [_I, _I, _I, _I, _P])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    for name, want in (("hvtpu_norm_threads", THREADS),
                       ("hvtpu_norm_group", GROUP),
                       ("hvtpu_norm_stat_rows", len(STAT_ROWS)),
                       ("hvtpu_norm_grad_rows", len(GRAD_ROWS))):
        query = getattr(lib, name)
        query.argtypes, query.restype = [], ctypes.c_int
        if query() != want:
            raise RuntimeError(f"norm: the library's {name} is not {want}")
    return lib


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused_norm: {what} launch failed with "
                           f"cudaError {err}")
    fused_norm.launches += 1


@functools.lru_cache(maxsize=None)
def _wave(device: int, kind: int, code: int, vec: int, variant: int) -> int:
    """CTAs of one kernel the card holds at once: its occupancy an SM
    times the SMs."""
    per_sm = ctypes.c_int(0)
    err = _library().hvtpu_norm_ctas_per_sm(kind, code, vec, variant,
                                             ctypes.byref(per_sm))
    if err != 0 or per_sm.value < 1:
        raise RuntimeError(f"fused_norm: the occupancy of kernel {kind} is "
                           f"unknown (cudaError {err})")
    props = torch.cuda.get_device_properties(device)
    return per_sm.value * props.multi_processor_count


def _plan_of(x: torch.Tensor, kind: int, vec: int, variant: int = 0):
    """(plan, its int64 array) of one launch over ``x``'s rows."""
    n, c, h, w = x.shape
    return _plan_array(n * h * w, c, vec, _wave(
        x.device.index, kind, _DTYPE_CODE[x.dtype], vec, variant))


_counters_lock = threading.Lock()
_counters = {}


def _counters_for(device: torch.device, stream: int) -> torch.Tensor:
    """The reduction kernels' arrival counters on ``stream``: zero between
    launches (the CTA that arrives last at a counter resets it), so the
    kernels in the stream's order share them."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None:
        with _counters_lock:
            buf = _counters.get(key)
            if buf is None:
                buf = torch.zeros(COUNTERS, dtype=torch.int32,
                                  device=device)
                _counters[key] = buf
    return buf


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: channels-last rows from a 16-byte
    aligned address (a copy where it is not, as a view's can be)."""
    if t.is_contiguous(memory_format=torch.channels_last):
        if t.data_ptr() % 16 == 0:
            return t
        return t.clone(memory_format=torch.channels_last)
    return t.contiguous(memory_format=torch.channels_last)


class _Config(NamedTuple):
    training: bool
    update: bool
    momentum: float
    one_minus_m: float
    epsilon: float
    relu: bool
    axis_name: object
    mesh: object


def _p(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class _FusedNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, residual, run_mean, run_var, cfg):
        lib = _library()
        dev = x.device
        c = x.shape[1]
        code = _DTYPE_CODE[x.dtype]
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        vec = vector_width(c, x.dtype)
        f32 = dict(dtype=torch.float32, device=dev)
        stats = torch.empty((len(STAT_ROWS), c), **f32)
        consts = (_p(scale), _p(bias), _p(run_mean), _p(run_var),
                  cfg.momentum, cfg.one_minus_m, cfg.epsilon)
        if cfg.training:
            p, parr = _plan_of(x, STATS, vec)
            partials = torch.empty((partial_rows(p), c, 2), **f32)
            sync = cfg.axis_name is not None
            out = torch.empty((2, c), **f32) if sync else stats
            _launched(lib.hvtpu_norm_stats(
                code, vec, parr.ctypes.data, x.data_ptr(),
                partials.data_ptr(), _counters_for(dev, stream).data_ptr(),
                out.data_ptr(), *consts, int(not sync), int(cfg.update),
                stream), "norm_stats")
            if sync:
                from ..parallel._collectives import pmean

                moments = pmean(out, cfg.axis_name, mesh=cfg.mesh)
                _launched(lib.hvtpu_norm_finalize(
                    code, c, moments.data_ptr(), stats.data_ptr(), *consts,
                    int(cfg.update), stream), "norm_finalize")
        else:
            _launched(lib.hvtpu_norm_finalize(
                code, c, None, stats.data_ptr(), *consts, 0, stream),
                "norm_finalize")
        y = torch.empty_like(x)
        variant = 2 * (residual is not None) + int(cfg.relu)
        _, parr = _plan_of(x, APPLY, vec, variant)
        _launched(lib.hvtpu_norm_apply(
            code, vec, parr.ctypes.data, x.data_ptr(), _p(residual),
            y.data_ptr(), stats.data_ptr(), int(cfg.relu), stream),
            "norm_apply")
        if cfg.update:
            torch.autograd.graph.increment_version((run_mean, run_var))
        saved = residual is not None and cfg.relu
        ctx.save_for_backward(x, y if saved else None, stats)
        ctx.cfg = cfg
        ctx.mask = (MASK_SAVED if saved else
                    MASK_RECOMPUTE if cfg.relu else MASK_NONE)
        ctx.residual = residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, stats = ctx.saved_tensors
        cfg, mask = ctx.cfg, ctx.mask
        lib = _library()
        dev = x.device
        c = x.shape[1]
        code = _DTYPE_CODE[x.dtype]
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        dy = _channels_last(dy)
        vec = vector_width(c, x.dtype)
        f32 = dict(dtype=torch.float32, device=dev)
        grads = torch.empty((len(GRAD_ROWS), c), **f32)
        p, parr = _plan_of(x, GRAD_REDUCE, vec, mask)
        partials = torch.empty((partial_rows(p), c, 2), **f32)
        _launched(lib.hvtpu_norm_grad_reduce(
            code, vec, parr.ctypes.data, mask, dy.data_ptr(),
            x.data_ptr(), _p(y), stats.data_ptr(), partials.data_ptr(),
            _counters_for(dev, stream).data_ptr(), grads.data_ptr(),
            int(cfg.training), stream), "norm_grad_reduce")
        dmom = grads[2:]
        if cfg.training and cfg.axis_name is not None:
            from ..parallel._collectives import pmean

            dmom = pmean(dmom, cfg.axis_name, mesh=cfg.mesh)
        need_x, need_r = ctx.needs_input_grad[0], ctx.needs_input_grad[3]
        dx = dr = None
        if mask == MASK_SAVED:
            dr = torch.empty_like(x)
        elif ctx.residual and need_r:
            dr = dy                     # no ReLU: the residual's is dy
        if need_x or mask == MASK_SAVED:
            dx = torch.empty_like(x)
            _, parr = _plan_of(x, GRAD_INPUT, vec, mask)
            _launched(lib.hvtpu_norm_grad_input(
                code, vec, parr.ctypes.data, mask, dy.data_ptr(),
                x.data_ptr(), _p(y), stats.data_ptr(), dmom.data_ptr(),
                dx.data_ptr(), _p(dr) if mask == MASK_SAVED else None,
                int(cfg.training), stream), "norm_grad_input")
        return (dx if need_x else None,
                grads[0] if ctx.needs_input_grad[1] else None,
                grads[1] if ctx.needs_input_grad[2] else None,
                dr if need_r else None, None, None, None)


def _check_cuda(x: torch.Tensor, residual: Optional[torch.Tensor],
                dtype: torch.dtype, tensors) -> None:
    if x.dim() != 4:
        raise ValueError(f"fused_norm: expects an NCHW tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or x.dtype != dtype:
        raise TypeError(f"fused_norm: a {x.dtype} input to a {dtype} norm "
                        "(the kernels take float32, bfloat16 or float16 in "
                        "the norm's dtype)")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError("fused_norm: the residual must match the input's "
                         "shape, dtype and device")
    for t in tensors:
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (x.shape[1],) or not t.is_contiguous()):
            raise ValueError("fused_norm: scale, bias and the running "
                             "stats must be contiguous float32 vectors of "
                             "the channels, on the input's device")


def fused_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, *, training: bool,
               update_running: bool = True, momentum: float,
               epsilon: float, dtype: Optional[torch.dtype] = None,
               residual: Optional[torch.Tensor] = None, relu: bool = False,
               axis_name=None, mesh=None) -> torch.Tensor:
    """``relu?(residual + norm(x))`` over dim 1 of an NCHW ``x`` (see the
    module's docstring); ``scale`` / ``bias`` float32 parameters,
    ``mean`` / ``var`` the float32 running stats, updated in place in
    training where ``update_running``; ``dtype`` the compute dtype
    (``x``'s by default).  CPU tensors take :func:`batch_norm_plain`."""
    dtype = dtype or x.dtype
    if x.device.type != "cuda":
        return batch_norm_plain(
            x, scale, bias, mean, var, training=training,
            update_running=update_running, momentum=momentum,
            epsilon=epsilon, dtype=dtype, residual=residual, relu=relu,
            axis_name=axis_name, mesh=mesh)
    _check_cuda(x, residual, dtype, (scale, bias, mean, var))
    x = _channels_last(x)
    if residual is not None:
        residual = _channels_last(residual)
    cfg = _Config(bool(training), bool(training and update_running),
                  _f32(momentum), _f32(1.0 - momentum), _f32(epsilon),
                  bool(relu), axis_name, mesh)
    return _FusedNorm.apply(x, scale, bias, residual, mean, var, cfg)


fused_norm.launches = 0
