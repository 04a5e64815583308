"""Ray integration surface: actors when Ray is live, local fallback
(counterpart of ``horovod_tpu/ray``).

Parity surface: ``horovod.ray.RayExecutor`` (horovod/ray/runner.py) —
``start()`` / ``run(fn)`` / ``run_remote``+``execute`` / ``shutdown``
driving one Horovod rank per Ray worker.

Two execution paths, chosen at ``start()``:

- **Ray actors** (parity: BaseHorovodWorker actors): when ``ray`` is
  importable AND ``ray.is_initialized()``, each rank runs inside a Ray
  actor (``num_cpus=cpus_per_worker``, ``num_gpus`` when asked).  The
  driver gathers each actor's node IP (and, with ``use_gpu``, its GPU
  ids), derives the rank/local/cross topology by host exactly like the
  port's launcher does by hostfile, points every rank at rank 0's node
  for the rendezvous, and runs ``fn`` on all actors.  Placement GROUPS
  stay out of scope — actors are scheduled by Ray's default scheduler.
- **local mode** otherwise: ranks as local worker processes through
  the port's launcher — the reference's own CI exercises RayExecutor
  on a local Ray cluster the same way.

``use_gpu`` is the caller's switch, as in upstream Horovod: with it
every rank runs on the card in both modes; ``use_gpu=False`` (or
``cpu_devices=1``) is the caller asking for the CPU over gloo.  Left
unset, it follows where the ranks run: a Ray actor gets upstream's
default, no card and the CPU, since Ray reserves none for it, while the
local mode and ``ElasticRayExecutor``, which place no actor, run their
ranks on the card.  A Ray actor sees only its own GPUs, while the
port's ``init()`` takes ``cuda:{local_rank}``, so every rank of a host
gets ``CUDA_VISIBLE_DEVICES`` set to that host's GPU ids with each
local rank's first id at its local rank's index (upstream's sharing of
the visible devices).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("horovod_tpu_torch")


def _probe_ray():
    """The live-Ray probe: a user with a real Ray cluster must get
    actors, not silently subprocesses on the driver node."""
    try:
        import ray
    except Exception:
        return None
    try:
        if not ray.is_initialized():
            return None
    except Exception:
        return None
    return ray


class _ActorWorker:
    """One rank inside a Ray actor process (parity:
    horovod/ray/runner.py BaseHorovodWorker)."""

    def node_info(self):
        """(node ip, a free port, this actor's GPU ids) — rank 0's
        answer seeds the rendezvous address for every rank; the GPU ids
        (empty without ``num_gpus``) make each host's
        ``CUDA_VISIBLE_DEVICES``."""
        import socket

        from ..runner.launch import find_free_port

        try:
            from ray.util import get_node_ip_address

            ip = get_node_ip_address()
        except Exception:
            ip = socket.gethostbyname(socket.gethostname())
        try:
            import ray

            gpu_ids = [str(g) for g in ray.get_gpu_ids()]
        except Exception:
            gpu_ids = []
        return ip, find_free_port(bind_addr=""), gpu_ids

    def setup(self, env: Dict[str, str]):
        import os

        os.environ.update(env)
        return True

    def execute(self, fn, args=(), kwargs=None):
        return fn(*args, **(kwargs or {}))


def _visible_devices(ids_by_rank: List[List[str]]) -> str:
    """One host's ``CUDA_VISIBLE_DEVICES`` from its ranks' GPU ids in
    local-rank order: each rank's first id at its local rank's index
    (``cuda:{local_rank}`` is then the rank's own card), the rest
    after."""
    first = [ids[0] for ids in ids_by_rank if ids]
    rest = [i for ids in ids_by_rank for i in ids[1:]]
    return ",".join(first + rest)


def _cpu_devices(use_gpu: Optional[bool],
                 cpu_devices: Optional[int]) -> Optional[int]:
    """The launcher's ``cpu_devices`` for the ranks: None (the card)
    with ``use_gpu``; the CPU when the caller turns ``use_gpu`` off
    (``cpu_devices``, else 1); left unset, ``cpu_devices`` as given
    (None, the card, unless the caller asks for the CPU)."""
    if use_gpu:
        return None
    if use_gpu is False:
        return cpu_devices or 1
    return cpu_devices


def _topology_envs(infos, env_vars=None, cpu_devices=None,
                   use_gpu: bool = False) -> List[Dict[str, str]]:
    """Per-rank launcher-equivalent env from the actors' node IPs:
    rank/size, local rank/size by host, cross rank/size per
    LOCAL RANK across hosts (exactly hosts.py get_host_assignments'
    derivation — the cross communicator is the set of hosts holding a
    slot at this local rank), and the rendezvous address on rank 0's
    node.  ``infos`` holds ``(ip, port)`` or ``(ip, port, gpu_ids)`` a
    rank; with ``use_gpu`` every rank of a host gets that host's
    ``CUDA_VISIBLE_DEVICES`` (``_visible_devices``)."""
    size = len(infos)
    ip0, port0 = infos[0][:2]
    ips = [info[0] for info in infos]
    hosts: List[str] = []
    for ip in ips:
        if ip not in hosts:
            hosts.append(ip)
    by_host = {h: [r for r, ip in enumerate(ips) if ip == h]
               for h in hosts}
    local_sizes = {len(v) for v in by_host.values()}
    uniform = local_sizes.pop() if len(local_sizes) == 1 else 0
    # cross layout per local_rank (mirrors runner/hosts.py): with a
    # ragged 2+1 placement, local_rank 1 exists on one host only, so
    # its cross communicator has size 1 — not the host count
    by_local_rank: Dict[int, List[str]] = {}
    for h in hosts:
        for lr in range(len(by_host[h])):
            by_local_rank.setdefault(lr, []).append(h)
    visible = {h: _visible_devices(
        [list(infos[r][2]) if len(infos[r]) > 2 else [] for r in ranks])
        for h, ranks in by_host.items()}
    envs = []
    for rank, ip in enumerate(ips):
        locals_ = by_host[ip]
        lr = locals_.index(rank)
        cross_hosts = by_local_rank[lr]
        env = {
            "HVTPU_RANK": str(rank),
            "HVTPU_SIZE": str(size),
            "HVTPU_LOCAL_RANK": str(lr),
            "HVTPU_LOCAL_SIZE": str(len(locals_)),
            "HVTPU_CROSS_RANK": str(cross_hosts.index(ip)),
            "HVTPU_CROSS_SIZE": str(len(cross_hosts)),
            "HVTPU_UNIFORM_LOCAL_SIZE": str(uniform),
            "HVTPU_COORDINATOR_ADDR": ip0,
            "HVTPU_COORDINATOR_PORT": str(port0),
        }
        if cpu_devices is not None:
            # same CPU forcing the local launcher path applies (actors
            # must not silently target a different backend than the
            # fallback would)
            env["HVTPU_CPU_DEVICES"] = str(cpu_devices)
        if use_gpu and visible[ip]:
            env["CUDA_VISIBLE_DEVICES"] = visible[ip]
        env.update(env_vars or {})
        envs.append(env)
    return envs


class RayExecutor:
    """Executor with the reference's lifecycle shape: Ray actors when
    a Ray cluster is live, local worker processes otherwise.  The local
    ranks run on the card unless the caller asks for the CPU
    (``use_gpu=False`` or ``cpu_devices=1``); actors take upstream's
    default, the CPU unless ``use_gpu``.

    >>> ex = RayExecutor(num_workers=2)
    >>> ex.start()
    >>> results = ex.run(train_fn, args=(cfg,))
    >>> ex.shutdown()
    """

    def __init__(self, settings=None, *, num_workers: Optional[int] = None,
                 num_hosts: Optional[int] = None,
                 num_workers_per_host: Optional[int] = None,
                 cpu_devices: Optional[int] = None,
                 env_vars: Optional[Dict[str, str]] = None,
                 use_gpu: Optional[bool] = None, cpus_per_worker: int = 1,
                 gpus_per_worker: Optional[int] = None):
        # reference world-size arithmetic: either num_workers directly
        # or num_hosts x num_workers_per_host — silently running a
        # different world size than asked would corrupt training
        if num_workers is None and num_hosts is not None:
            num_workers = num_hosts * (num_workers_per_host or 1)
        elif (num_workers is not None and num_hosts is not None
              and num_workers != num_hosts * (num_workers_per_host or 1)):
            raise ValueError(
                "specify num_workers OR num_hosts*num_workers_per_host, "
                "not conflicting values of both"
            )
        self.num_workers = num_workers or 2
        self.cpu_devices = cpu_devices
        self.env_vars = env_vars
        self.use_gpu = use_gpu
        self.cpus_per_worker = cpus_per_worker
        self.gpus_per_worker = gpus_per_worker
        self._started = False
        self._ray = None
        self._actors: Optional[list] = None

    def start(self):
        """Probe for a live Ray cluster; create one actor per rank
        when found (parity: RayExecutor.start creating
        BaseHorovodWorker actors), else arm the local fallback."""
        self._ray = _probe_ray()
        if self._ray is not None:
            self._start_actors()
        else:
            logger.info(
                "RayExecutor: no initialized Ray cluster found; "
                "running ranks as local worker processes")
        self._started = True

    def _start_actors(self):
        ray = self._ray
        opts: Dict[str, Any] = {"num_cpus": self.cpus_per_worker}
        if self.use_gpu:
            opts["num_gpus"] = self.gpus_per_worker or 1
        actor_cls = ray.remote(**opts)(_ActorWorker)
        self._actors = [actor_cls.remote()
                        for _ in range(self.num_workers)]
        infos = ray.get(
            [a.node_info.remote() for a in self._actors])
        # CPU forcing must never override reserved cards: use_gpu
        # actors run on their GPUs; an actor without one runs on the CPU
        envs = _topology_envs(
            infos, self.env_vars,
            _cpu_devices(bool(self.use_gpu), self.cpu_devices),
            use_gpu=bool(self.use_gpu))
        ray.get([a.setup.remote(e)
                 for a, e in zip(self._actors, envs)])

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[Dict[str, Any]] = None) -> List[Any]:
        """Run ``fn`` on every rank, return per-rank results ordered by
        rank (parity: RayExecutor.run)."""
        if not self._started:
            raise RuntimeError("RayExecutor.start() must be called first")
        if self._actors is not None:
            return self._ray.get(
                self.run_remote(fn, args=args, kwargs=kwargs))
        from .. import runner

        return runner.run(
            fn, args=args, kwargs=kwargs, np=self.num_workers,
            # no actor holds these ranks: the card unless the caller
            # asks for the CPU
            cpu_devices=_cpu_devices(self.use_gpu, self.cpu_devices),
            env=self.env_vars,
        )

    # reference API aliases
    def run_remote(self, fn: Callable, args: tuple = (),
                   kwargs: Optional[Dict[str, Any]] = None):
        """Actor mode returns Ray ObjectRefs to pass to ``execute``
        (reference contract); local mode executes eagerly and returns
        the results list."""
        if self._actors is not None:
            return [a.execute.remote(fn, args, kwargs)
                    for a in self._actors]
        return self.run(fn, args=args, kwargs=kwargs)

    def execute(self, fn_or_results):
        """Reference shape: ``execute(fn)`` runs fn on every worker.
        Also accepts the output of :meth:`run_remote` (ObjectRefs in
        actor mode, a results list in local mode)."""
        if callable(fn_or_results):
            return self.run(fn_or_results)
        if self._actors is not None and isinstance(fn_or_results, list):
            return self._ray.get(fn_or_results)
        return fn_or_results

    def shutdown(self):
        if self._actors is not None:
            for a in self._actors:
                try:
                    self._ray.kill(a)
                except Exception:
                    pass
            self._actors = None
        self._ray = None
        self._started = False


class ElasticRayExecutor:
    """Elastic executor with the reference's lifecycle shape (parity:
    ``horovod.ray.ElasticRayExecutor``): ``start()`` then ``run(fn)``
    where ``fn`` follows the elastic contract (``hvd.elastic.TorchState``
    + ``@hvd.elastic.run``).  Local-mode: ranks are launched under the
    elastic DRIVER (restart-based reconfiguration, durable commits),
    not Ray actors — placement-group scheduling stays out of scope.  A
    ``host_discovery_script`` makes the world resize live, the
    reference's Ray-autoscaler discovery analog.  The ranks run on the
    card unless the caller asks for the CPU (``use_gpu=False`` or
    ``cpu_devices=1``); the reference accepts ``use_gpu`` and ignores
    it."""

    def __init__(self, settings=None, *,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 num_workers: Optional[int] = None,
                 cpu_devices: Optional[int] = None,
                 env_vars: Optional[Dict[str, str]] = None,
                 host_discovery_script: Optional[str] = None,
                 override_discovery: bool = True,  # source compat
                 use_gpu: Optional[bool] = None, cpus_per_worker: int = 1,
                 gpus_per_worker: Optional[int] = None):
        # reference source compat: ElasticRayExecutor carries its
        # elastic bounds in a settings object (create_settings(min_np,
        # max_np, ...)); honor those rather than silently dropping them
        if settings is not None:
            min_workers = min_workers or getattr(
                settings, "min_np", None) or getattr(
                settings, "min_workers", None)
            max_workers = max_workers or getattr(
                settings, "max_np", None) or getattr(
                settings, "max_workers", None)
            host_discovery_script = host_discovery_script or getattr(
                settings, "discovery_script", None)
        self.num_workers = num_workers or max_workers or min_workers or 2
        self.min_workers = min_workers
        self.max_workers = max_workers
        if min_workers is not None and min_workers > self.num_workers:
            raise ValueError(
                f"min_workers={min_workers} exceeds the world size "
                f"{self.num_workers} (num_workers/max_workers): the "
                "static local discovery could never satisfy it")
        self.cpu_devices = cpu_devices
        self.env_vars = env_vars
        self.host_discovery_script = host_discovery_script
        self.use_gpu = use_gpu
        self._started = False

    @staticmethod
    def create_settings(min_np: Optional[int] = None,
                        max_np: Optional[int] = None,
                        discovery_script: Optional[str] = None,
                        **_ignored):
        """Reference-shaped settings factory (parity:
        ElasticRayExecutor.create_settings): a plain namespace the
        constructor reads its elastic bounds from."""
        from types import SimpleNamespace

        return SimpleNamespace(min_np=min_np, max_np=max_np,
                               discovery_script=discovery_script)

    def start(self):
        self._started = True

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[Dict[str, Any]] = None) -> List[Any]:
        """Run ``fn`` under the elastic driver; per-rank results of the
        final world, ordered by rank."""
        if not self._started:
            raise RuntimeError(
                "ElasticRayExecutor.start() must be called first")
        from .. import runner

        return runner.run_elastic(
            fn, args=args, kwargs=kwargs,
            num_proc=self.num_workers,
            min_np=self.min_workers, max_np=self.max_workers,
            cpu_devices=_cpu_devices(self.use_gpu, self.cpu_devices),
            env=self.env_vars,
            host_discovery_script=self.host_discovery_script,
        )

    def shutdown(self):
        self._started = False
