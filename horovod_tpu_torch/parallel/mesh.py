"""Mesh layouts for hybrid dp/tp/pp/sp/ep parallelism.

Counterpart of ``horovod_tpu/parallel/mesh.py``: ``MeshLayout``,
``make_layout`` and ``auto_layout`` with the reference's factorization,
physical axis order and logical->physical mapping (``sp`` shares the
``tp`` group and ``ep`` the ``dp`` group unless given a size of their
own), over a ``torch.distributed`` ``DeviceMesh`` of the world's ranks
(``hvd.mesh``, row-major, so rank r has the mesh coordinates of JAX
device r).  A device is a rank here (one device a process), so the
reference's ``devices=`` is the world: a layout over a subset of it
raises.  Making a layout is collective: every rank makes the same ones
in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

LOGICAL_AXES = ("dp", "pp", "tp", "sp", "ep")


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A physical mesh plus the logical->physical axis mapping.

    ``axis("sp")`` returns the physical mesh-axis name the collectives
    take for sequence parallelism, which may be ``"tp"`` when sp shares
    the tensor-parallel group.
    """

    mesh: Any                       # torch.distributed DeviceMesh
    logical_to_physical: Dict[str, str]

    def axis(self, logical: str) -> str:
        if logical not in self.logical_to_physical:
            raise KeyError(
                f"unknown logical axis {logical!r}; have "
                f"{sorted(self.logical_to_physical)}"
            )
        return self.logical_to_physical[logical]

    def axis_size(self, logical: str) -> int:
        return self.shape[self.axis(logical)]

    @property
    def shape(self) -> Dict[str, int]:
        """Physical axis name -> size, in the mesh's order (the
        reference's ``mesh.shape``)."""
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def dp(self) -> str:
        return self.axis("dp")

    @property
    def tp(self) -> str:
        return self.axis("tp")

    @property
    def pp(self) -> str:
        return self.axis("pp")

    @property
    def sp(self) -> str:
        return self.axis("sp")

    @property
    def ep(self) -> str:
        return self.axis("ep")


def _factor_default(n: int) -> Dict[str, int]:
    """Balanced default factorization of ``n`` devices into pp x dp x tp:
    tp first (at most 4 past 4 devices), then pp 2 when what is left is
    even, dp the rest."""
    tp = 1
    for cand in (2, 4, 8):
        if n % cand == 0 and cand <= n:
            tp = cand
        else:
            break
    tp = min(tp, 4) if n > 4 else tp
    rem = n // tp
    pp = 2 if rem % 2 == 0 and rem >= 2 else 1
    dp = rem // pp
    return {"pp": pp, "dp": dp, "tp": tp}


def _world_size(devices) -> int:
    from ..core.state import size

    n = size()
    if devices is not None and [int(d) for d in devices] != list(range(n)):
        raise ValueError(
            f"a layout spans the whole world of {n} ranks (one device a "
            f"process); got devices {list(devices)}, not range({n})")
    return n


def make_layout(
    devices: Optional[Sequence[int]] = None,
    *,
    dp: Optional[int] = None,
    tp: int = 1,
    pp: int = 1,
    sp: Optional[int] = None,
    ep: Optional[int] = None,
) -> MeshLayout:
    """Build a :class:`MeshLayout` over the world's ranks.

    ``devices`` is ``None`` or the world's ranks ``range(hvd.size())``.
    ``dp=None`` means "whatever is left" after tp/pp (and dedicated
    sp/ep, if given).  ``sp``/``ep`` of ``None`` share tp/dp
    respectively; an explicit integer size allocates a dedicated
    physical axis.
    """
    n = _world_size(devices)

    phys_sizes: Dict[str, int] = {}
    logical_to_physical = {"dp": "dp", "tp": "tp", "pp": "pp"}

    denom = tp * pp
    if sp is not None:
        phys_sizes["sp"] = sp
        logical_to_physical["sp"] = "sp"
        denom *= sp
    else:
        logical_to_physical["sp"] = "tp"
    if ep is not None:
        phys_sizes["ep"] = ep
        logical_to_physical["ep"] = "ep"
        denom *= ep
    else:
        logical_to_physical["ep"] = "dp"

    if dp is None:
        if n % denom != 0:
            raise ValueError(
                f"{n} devices not divisible by tp*pp(*sp*ep)={denom}"
            )
        dp = n // denom
    total = dp * denom
    if total != n:
        raise ValueError(
            f"mesh size {total} (dp={dp} tp={tp} pp={pp} sp={sp} ep={ep})"
            f" != {n} devices"
        )

    # Physical axis order, slowest-varying first: pp, dp, the dedicated
    # ep and sp, tp innermost (the reference's).
    order: Tuple[str, ...] = ("pp", "dp")
    shape = [pp, dp]
    if "ep" in phys_sizes:
        order = order + ("ep",)
        shape.append(phys_sizes["ep"])
    if "sp" in phys_sizes:
        order = order + ("sp",)
        shape.append(phys_sizes["sp"])
    order = order + ("tp",)
    shape.append(tp)

    from ..core.state import mesh

    return MeshLayout(mesh=mesh(order, shape),
                      logical_to_physical=logical_to_physical)


def auto_layout(devices: Optional[Sequence[int]] = None) -> MeshLayout:
    """Default hybrid layout for the world (pp x dp x tp, with sp sharing
    tp and ep sharing dp)."""
    f = _factor_default(_world_size(devices))
    return make_layout(devices, dp=f["dp"], tp=f["tp"], pp=f["pp"])
