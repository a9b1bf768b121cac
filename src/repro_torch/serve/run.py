"""``serve_run``: one live serve run, batteries included.  Port of
``repro.serve.run``.

Mirrors ``run_event_driven``'s signature (config, the four callables,
``device``, ``perm_fn``) and returns the same ``RunResult``, so moving
an experiment from simulation to service is a one-line change:

    res = serve_run(cfg, init_params_fn=..., loss_fn=...,
                    fed_data=data, evaluate_fn=..., device="cuda")

Drivers:

* ``driver="thread"`` (default): one free-running thread per client,
  real concurrency, arrival order is whatever the fleet produces.
* ``driver="sequential"``: the determinism bridge: one thread plays
  every client in scheduler order; with ``buffer_size=1`` the result is
  bit-identical to ``run_event_driven``.

``launch_serving`` returns the un-started pieces (server and workers)
for callers composing their own lifecycles (multi-tenant, benchmarks).
``live=`` serves the run's telemetry over HTTP while it runs.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.config import resolve_device
from repro_torch.core.metrics import RunResult
from repro_torch.core.scheduler import SpeedModel
from repro_torch.serve.client import (ClientCompute, ScenarioPacer, SequentialDriver,
                                      ThreadClientWorker)
from repro_torch.serve.server import FLServer
from repro_torch.serve.transport import Transport, get_transport

DRIVERS = ("thread", "sequential")


def resolve_live(live, servers):
    """Normalise a user-facing ``live=`` value into a STARTED
    ``ObsHttpServer`` over ``servers`` (or None): True gives the defaults
    (127.0.0.1, an ephemeral port), an int that port, a dict
    ``ObsHttpServer`` kwargs (host/port/probes).  The plane is attached
    to each server as ``.live`` so callers holding only the server can
    find the bound port."""
    if live is None or live is False:
        return None
    if live is True:
        kw = {}
    elif isinstance(live, int):
        kw = {"port": live}
    elif isinstance(live, dict):
        kw = dict(live)
    else:
        raise ValueError("live must be None/False (off), True (ephemeral port), an int port, "
                         f"or a dict of ObsHttpServer kwargs; got {live!r}")
    from repro_torch.obs.live import ObsHttpServer
    plane = ObsHttpServer(servers, **kw).start()
    for s in servers:
        s.live = plane
    return plane


def _resolve_transport(transport, num_clients: int, capacity: int, device):
    if isinstance(transport, Transport):
        return transport, False
    return get_transport(transport)(num_clients, capacity, device=device), True


def _resolve_pacer(pace, run_cfg):
    """``pace``: None (free-run), True (the run's scenario compute fleet,
    paper_testbed when none), a SpeedModel, or a ready ScenarioPacer."""
    if pace is None or pace is False:
        return None
    if isinstance(pace, ScenarioPacer):
        return pace
    if pace is True:
        from repro_torch.core.runtimes.common import _scenario_models
        compute, _, _ = _scenario_models(run_cfg, run_cfg.num_clients)
        pace = compute or SpeedModel.paper_testbed(run_cfg.num_clients, run_cfg.seed)
    return ScenarioPacer(pace)


def launch_serving(run_cfg, *, init_params_fn, loss_fn, fed_data, evaluate_fn,
                   client_eval_fn=None, transport="inproc", capacity: int = 0, pace=None,
                   speed=None, rounds: Optional[int] = None, recv_timeout: float = 30.0,
                   retry=None, exchange_timeout: Optional[float] = None,
                   liveness_timeout: Optional[float] = None, verbose: bool = False,
                   name: str = "default", device="cuda", perm_fn=None):
    """Build (but do not start) one federation's serving pieces:
    ``(server, workers, transport)``.  The caller owns the lifecycle:
    ``server.start()``, start the workers, then ``server.run()`` or
    compose ``server.step()`` into a larger loop (multi-tenant).

    ``retry`` is a ``repro_torch.resilience.RetryPolicy`` for every
    client's exchanges; ``exchange_timeout`` / ``liveness_timeout`` are
    the server's per-exchange and dead-client deadlines (seconds; None
    is off); ``name`` labels the tenant."""
    dev = resolve_device(device)
    tr, _owned = _resolve_transport(transport, run_cfg.num_clients, capacity, dev)
    server = FLServer(run_cfg, init_params_fn=init_params_fn, evaluate_fn=evaluate_fn,
                      transport=tr, speed=speed, exchange_timeout=exchange_timeout,
                      liveness_timeout=liveness_timeout, verbose=verbose, name=name,
                      device=dev)
    compute = ClientCompute.for_run(run_cfg, loss_fn=loss_fn, fed_data=fed_data,
                                    client_eval_fn=client_eval_fn or evaluate_fn, device=dev,
                                    perm_fn=perm_fn)
    pacer = _resolve_pacer(pace, run_cfg)
    workers = [ThreadClientWorker(compute, tr.client_channel(i), i, pacer=pacer, rounds=rounds,
                                  recv_timeout=recv_timeout, retry=retry)
               for i in range(run_cfg.num_clients)]
    return server, workers, tr


def serve_run(run_cfg, *, init_params_fn, loss_fn, fed_data, evaluate_fn,
              client_eval_fn=None, transport="inproc", driver: str = "thread",
              capacity: int = 0, pace=None, speed=None, stall_timeout: float = 60.0,
              recv_timeout: float = 30.0, retry=None, exchange_timeout: Optional[float] = None,
              liveness_timeout: Optional[float] = None, verbose: bool = False, live=None,
              device="cuda", perm_fn=None) -> RunResult:
    """Run one federation as a live service on ``device`` and return its
    RunResult.  ``perm_fn`` is the local update's permutation hook
    (``core.client``); the sequential driver passes it the event index,
    as ``run_event_driven`` does, and thread workers their own round.
    ``live`` turns on the HTTP telemetry plane for the run (True / port /
    dict, see ``resolve_live``); the bound plane is ``server.live`` while
    the run is up."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; known: {DRIVERS}")
    dev = resolve_device(device)
    if driver == "sequential":
        if live:
            raise ValueError("live telemetry needs the thread driver: the sequential bridge "
                             "runs in one thread with nothing to watch concurrently")
        tr, owned = _resolve_transport(transport, run_cfg.num_clients, capacity, dev)
        # resume_fresh_clients=False: the bridge driver rebuilds each
        # client's exact state (base tree, version, seq) from the restored
        # server, so a cfg.resume run continues bit-identically
        server = FLServer(run_cfg, init_params_fn=init_params_fn, evaluate_fn=evaluate_fn,
                          transport=tr, speed=speed, account_bytes=False,
                          resume_fresh_clients=False, verbose=verbose, device=dev)
        compute = ClientCompute.for_run(run_cfg, loss_fn=loss_fn, fed_data=fed_data,
                                        client_eval_fn=client_eval_fn or evaluate_fn,
                                        device=dev, perm_fn=perm_fn)
        try:
            return SequentialDriver(server, compute).run()
        finally:
            if owned:
                tr.close()
    server, workers, tr = launch_serving(
        run_cfg, init_params_fn=init_params_fn, loss_fn=loss_fn, fed_data=fed_data,
        evaluate_fn=evaluate_fn, client_eval_fn=client_eval_fn, transport=transport,
        capacity=capacity, pace=pace, speed=speed, recv_timeout=recv_timeout, retry=retry,
        exchange_timeout=exchange_timeout, liveness_timeout=liveness_timeout,
        verbose=verbose, device=dev, perm_fn=perm_fn)
    plane = None
    try:
        plane = resolve_live(live, [server])
        server.start()
        for w in workers:
            w.start()
        res = server.run(stall_timeout=stall_timeout)
        for w in workers:
            w.stop()
        for w in workers:
            w.join(timeout=5.0)
        # fold client-side stats (retry counts) into the sealed metrics
        server.absorb_client_stats(workers)
        errors = [w.error for w in workers if w.error is not None]
        if errors:
            raise RuntimeError(f"{len(errors)} client worker(s) failed; the first: "
                               f"{errors[0]!r}") from errors[0]
        return res
    finally:
        if plane is not None:
            plane.stop()
        tr.close()
