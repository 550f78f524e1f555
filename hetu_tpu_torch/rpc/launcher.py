"""Bring up a serving fleet (counterpart of the fleet half of
``hetu_tpu/rpc/launcher.py``): N in-process replicas behind one
:class:`~hetu_tpu_torch.serving.router.Router`, and an optional front
door speaking the whole line protocol.

Replicas are engines whose loops run on threads of this process, the
shape of a fleet on one card. Engine processes (``remote=True``), the
elastic worker pool and the distributed bootstrap are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Sequence

log = logging.getLogger("hetu_tpu_torch.rpc")


@dataclasses.dataclass
class FleetHandle:
    """A launched serving fleet: the router, its replica names and the
    optional front door (``coordinator``, bound to ``port``). ``stop()``
    tears down the front door, then the router and every replica's loop
    (the reverse of the launch order)."""

    router: object                   # serving.router.Router
    replicas: list
    coordinator: Optional[object] = None   # PyCoordinatorServer | None
    port: Optional[int] = None

    def stop(self) -> None:
        if self.coordinator is not None:
            self.coordinator.stop()
        self.router.stop()


def launch_serving_fleet(build_engine: Callable[[int], object],
                         n_replicas: int = 2, *,
                         names: Optional[Sequence[str]] = None,
                         roles: Optional[dict] = None,
                         port: Optional[int] = None,
                         bind: str = "127.0.0.1", token: str = "",
                         remote: bool = False,
                         **router_kw) -> FleetHandle:
    """Bring up a serving fleet (``hetu_tpu/rpc/launcher.py:414``): N
    replicas, each ``build_engine(i)`` (a fresh ``ServingEngine``,
    registered, which starts its loop, before the next is built: a
    replica captures its lanes while its peers serve), one Router over
    them, and, when ``port`` is given (0: a free one, then
    :attr:`FleetHandle.port`), a coordinator serving the Router: SUBMIT,
    RESULT and GENERATE across the fleet, FLEET, DRAIN, RESUME,
    FLEETMETRICS, HEALTHZ and METRICS. ``roles`` maps a replica name to
    ``prefill``, ``decode`` or ``both`` (the default) for a
    prefill/decode split; ``router_kw`` goes to the Router.

    ``remote=True`` (one engine process a replica) raises ValueError: it
    comes with the engine processes, in a later part of the port."""
    from hetu_tpu_torch.serving.router import Router

    if remote:
        raise ValueError(
            "remote=True (engine processes behind RemoteEngineProxy) is "
            "not ported yet: it comes with serving/fleet.py's engine "
            "processes and the distributed checkpoint; launch in-process "
            "replicas")
    names = list(names) if names is not None \
        else [f"r{i}" for i in range(n_replicas)]
    if len(names) != n_replicas:
        raise ValueError(f"{len(names)} names for {n_replicas} replicas")
    roles = dict(roles or {})
    router = Router(**router_kw)
    handle = FleetHandle(router=router, replicas=names)
    try:
        for i, name in enumerate(names):
            router.register(name, build_engine(i),
                            role=roles.get(name, "both"))
        if port is not None:
            from hetu_tpu_torch.rpc.py_server import PyCoordinatorServer
            handle.coordinator = PyCoordinatorServer(
                port, bind=bind, token=token, serving=router)
            handle.coordinator.start()
            handle.coordinator.wait_ready()
            handle.port = handle.coordinator.port
    except BaseException:
        handle.stop()            # no half-launched fleet left running
        raise
    log.info(f"serving fleet up: {n_replicas} in-process replicas "
             f"({', '.join(names)})"
             + (f", coordinator :{handle.port}" if port is not None
                else ""))
    return handle


__all__ = ["FleetHandle", "launch_serving_fleet"]
