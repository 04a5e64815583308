"""Network-interface discovery for the launcher.

Parity surface: ``horovod/runner/driver/driver_service.py`` — before a
multi-host launch the reference starts a driver service, has every host
probe its NICs, and intersects the routable interface set so workers
get a rendezvous address they can actually reach
(``HorovodRunDriverService`` + ``network.get_local_host_addresses``).

A copy of ``horovod_tpu/runner/nic.py``.  The port's rendezvous store
(a ``TCPStore``) lives in rank 0's worker, so only rank 0's host needs
probing — workers just need ONE address of
that host which is routable from the others.  The probe prefers
globally-scoped, up, non-loopback IPv4 interfaces from ``ip -j addr``
(with a pure-socket fallback), and ``--network-interface`` accepts an
interface NAME (resolved here, as the reference's flag does) or a
literal address.
"""

from __future__ import annotations

import json
import socket
import subprocess
from typing import List, Tuple


def local_interfaces(usable_only: bool = False) -> List[Tuple[str, str]]:
    """``[(ifname, ipv4_addr), ...]`` for this host.  Uses
    ``ip -j addr``; falls back to resolving the hostname when ``ip`` is
    unavailable (containers, macOS).

    ``usable_only=True`` keeps only addresses a remote peer could
    plausibly reach: globally-scoped (drops loopback and 169.254/…
    link-local) on interfaces that are not operationally DOWN — the
    filter the coordinator probe needs so a docker bridge or dead NIC
    listed first in ifindex order cannot silently hang the rendezvous.
    """
    try:
        out = subprocess.run(
            ["ip", "-j", "addr"], capture_output=True, text=True,
            timeout=10, check=True,
        ).stdout
        result = []
        for iface in json.loads(out):
            if usable_only and iface.get("operstate") == "DOWN":
                continue
            for info in iface.get("addr_info", []):
                if info.get("family") != "inet":
                    continue
                if usable_only and info.get("scope") != "global":
                    continue
                result.append((iface["ifname"], info["local"]))
        if result or usable_only:
            return result
    except Exception:  # noqa: BLE001 — any failure falls through
        pass
    result = [] if usable_only else [("lo", "127.0.0.1")]
    try:
        for addr in socket.gethostbyname_ex(socket.gethostname())[2]:
            if not addr.startswith("127."):
                result.append(("host", addr))
    except OSError:
        pass
    return result


def resolve_interface(nic: str) -> str:
    """``--network-interface`` value → coordinator address.  Accepts an
    interface name (``eth0`` — resolved like the reference's flag) or a
    literal address/hostname.  A value that is neither a local
    interface nor resolvable as an address raises immediately (a typo
    must not become a silent rendezvous hang)."""
    ifaces = local_interfaces()
    for ifname, addr in ifaces:
        if nic == ifname:
            return addr
    try:
        socket.getaddrinfo(nic, None)
        return nic
    except OSError:
        names = ", ".join(sorted({n for n, _ in ifaces}))
        raise ValueError(
            f"--network-interface {nic!r} is neither a local interface "
            f"(have: {names}) nor a resolvable address"
        ) from None


def _egress_addr(probe_target: str) -> str | None:
    """The local address the kernel's routing table picks to reach
    ``probe_target`` — a connect() on a UDP socket does the route
    lookup without sending a packet.  Returns None when no route."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((probe_target, 9))
            return s.getsockname()[0]
    except OSError:
        return None


def probe_coordinator_addr(remote_host: str | None = None) -> str:
    """A usable (global-scope, iface up) non-loopback IPv4 address of
    this host that remote workers can plausibly reach (the reference's
    NIC intersection degenerates to this when only rank 0's host serves
    the rendezvous).

    Preference order: the EGRESS address toward ``remote_host`` (or a
    public anchor when none is given) — i.e. the interface carrying the
    actual route — then the first usable interface.  Enumeration order
    alone is a trap: a docker/VM bridge (172.17.0.1 is global scope on
    an UP interface) can sort first and silently hang remote workers
    until the rendezvous timeout.  Raises with the
    ``--network-interface`` escape hatch when no address exists."""
    usable = [a for _, a in local_interfaces(usable_only=True)
              if not a.startswith("127.")]
    if not usable:
        raise ValueError(
            "no usable non-loopback interface found for the coordinator; "
            "pass --network-interface with an address remote hosts can "
            "reach"
        )
    for target in filter(None, (remote_host, "8.8.8.8")):
        egress = _egress_addr(target)
        if egress in usable:
            return egress
    return usable[0]
