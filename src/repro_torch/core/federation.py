"""``Federation``: the one-object public API for an FL experiment.  Port
of ``repro.core.federation``.

    from repro_torch.core.federation import Federation

    fed = Federation(model="cnn", data=fed_data, test_data=(xte, yte),
                     algorithm="vafl", compressor="topk0.1_int8",
                     scenario="mobile_fleet")
    result = fed.run(rounds=200, mode="round")     # or mode="event"
    result = fed.serve(rounds=200)                 # the same, as a live service

``model`` is "mlp", "cnn", a ``(forward_fn, init_fn, model_cfg)``
triple, or omitted when explicit ``init_params_fn``/``loss_fn``/
``evaluate_fn`` are passed.  ``obs`` is ``True`` or a
``repro_torch.obs.ObsConfig`` enabling dual-timeline tracing, metrics
and exporters (``None``, the default, is off); ``checkpoint_path=``,
``checkpoint_every=`` and ``resume=`` make a run resumable.  The federation lives on ``device``, a CUDA
device unless the caller asks for the CPU; it never falls back on its
own.  Extra keyword arguments flow into ``FLRunConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.client import (LocalSpec, make_evaluator,
                                     make_weighted_classifier_loss)
from repro_torch.core.config import FLRunConfig, resolve_device
from repro_torch.core.runtimes import run_event_driven, run_round_based

MODES = ("round", "event")


def _resolve_model(model):
    """"mlp"/"cnn" shorthands or a (forward_fn, init_fn, cfg) triple."""
    if isinstance(model, str):
        from repro_torch.models.cnn import (CNNConfig, MLPConfig, cnn_forward,
                                            cnn_init, mlp_forward, mlp_init)
        if model == "mlp":
            return mlp_forward, mlp_init, MLPConfig(hidden=(128, 64))
        if model == "cnn":
            return cnn_forward, cnn_init, CNNConfig()
        raise ValueError(f"unknown model {model!r}; known: 'mlp', 'cnn' "
                         "(or pass a (forward_fn, init_fn, cfg) triple)")
    try:
        forward_fn, init_fn, cfg = model
    except (TypeError, ValueError):
        raise ValueError("model must be 'mlp', 'cnn', or a (forward_fn, init_fn, "
                         f"model_cfg) triple; got {model!r}") from None
    return forward_fn, init_fn, cfg


class Federation:
    """A configured federation: data + model + algorithm + codecs on one
    device, ready to ``run()``."""

    def __init__(self, *, data, model="mlp", test_data=None,
                 algorithm: str = "vafl", compressor: str = "identity",
                 broadcast_compressor: Optional[str] = None,
                 local: Optional[LocalSpec] = None,
                 init_params_fn: Optional[Callable] = None,
                 loss_fn: Optional[Callable] = None,
                 evaluate_fn: Optional[Callable] = None,
                 client_eval_fn: Optional[Callable] = None,
                 scenario=None, obs=None, eval_batch: int = 500, device="cuda",
                 **config):
        self.device = resolve_device(device)
        self.data = data
        num_clients = len(data.counts)
        if config.pop("num_clients", num_clients) != num_clients:
            raise ValueError(f"num_clients is derived from the data ({num_clients} "
                             "clients in data.counts); don't pass a different value")

        explicit = (init_params_fn, loss_fn, evaluate_fn)
        self._eval_spec = None      # (fwd, cfg, xte, yte, batch) or None
        self._subsampled_evals = {}    # (eval_subsample, seed) -> evaluator
        if any(f is not None for f in explicit):
            if not all(f is not None for f in explicit):
                raise ValueError("explicit mode needs all of init_params_fn, loss_fn "
                                 "and evaluate_fn (got a partial set)")
            self.init_params_fn = init_params_fn
            self.loss_fn = loss_fn
            self.evaluate_fn = evaluate_fn
        else:
            forward_fn, init_fn, mcfg = _resolve_model(model)
            if test_data is None:
                raise ValueError("test_data=(test_images, test_labels) is required "
                                 "unless an explicit evaluate_fn is passed")
            xte, yte = test_data
            batch = min(eval_batch, len(yte))
            self.init_params_fn = lambda g: init_fn(mcfg, g)
            self.loss_fn = make_weighted_classifier_loss(forward_fn, mcfg)
            self.evaluate_fn = make_evaluator(forward_fn, mcfg, xte, yte, batch=batch,
                                              device=self.device)
            self._eval_spec = (forward_fn, mcfg, xte, yte, batch)
        self.client_eval_fn = client_eval_fn

        config.setdefault("events_per_eval", num_clients)
        self.config = FLRunConfig(
            algorithm=algorithm, num_clients=num_clients, local=local or LocalSpec(),
            compressor=compressor, broadcast_compressor=broadcast_compressor,
            scenario=scenario, obs=obs, **config)

    def _client_eval_for(self, cfg):
        """The per-client evaluator for one run: the explicit
        ``client_eval_fn``, or under ``eval_subsample`` a deterministic
        subsampled evaluator built once per (subsample, seed)."""
        if not cfg.eval_subsample:
            return self.client_eval_fn
        if self.client_eval_fn is not None:
            raise ValueError("eval_subsample conflicts with an explicit client_eval_fn; "
                             "build the evaluator with make_evaluator(..., subsample=...)")
        if self._eval_spec is None:
            raise ValueError("eval_subsample needs the federation's test data (model "
                             "mode); in explicit-fn mode pass a subsampled client_eval_fn")
        key = (cfg.eval_subsample, cfg.seed)
        if key not in self._subsampled_evals:
            fwd, mcfg, xte, yte, batch = self._eval_spec
            self._subsampled_evals[key] = make_evaluator(
                fwd, mcfg, xte, yte, batch=batch, subsample=cfg.eval_subsample,
                subsample_seed=cfg.seed, device=self.device)
        return self._subsampled_evals[key]

    def run(self, rounds: Optional[int] = None, *, mode: str = "round", speed=None,
            perm_fn=None, verbose: bool = False, **overrides):
        """Run the federation and return a ``RunResult``.

        ``mode``: "round" (the paper's Algorithm 1) or "event" (the
        wall-clock async simulation; for sync-barrier algorithms like
        fedavg, the round barrier).  ``speed`` is the event runtime's
        compute model (default: the scenario's fleet, else the paper's
        testbed); ``perm_fn`` is the local update's permutation hook
        (``core.client``).  ``rounds`` and any other ``FLRunConfig``
        field can be overridden per call."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
        if "num_clients" in overrides:
            raise ValueError("num_clients is fixed by the federation's data; it "
                             "cannot be overridden per run")
        if rounds is not None:
            overrides["rounds"] = rounds
        cfg = dataclasses.replace(self.config, **overrides) if overrides else self.config
        kw = dict(init_params_fn=self.init_params_fn, loss_fn=self.loss_fn,
                  fed_data=self.data, evaluate_fn=self.evaluate_fn,
                  client_eval_fn=self._client_eval_for(cfg), device=self.device,
                  perm_fn=perm_fn, verbose=verbose)
        if mode == "round":
            return run_round_based(cfg, **kw)
        return run_event_driven(cfg, speed=speed, **kw)

    def serve(self, rounds: Optional[int] = None, *, transport="inproc",
              driver: str = "thread", pace=None, speed=None, retry=None,
              exchange_timeout: Optional[float] = None,
              liveness_timeout: Optional[float] = None, stall_timeout: float = 60.0,
              recv_timeout: float = 30.0, perm_fn=None, live=None, verbose: bool = False,
              **overrides):
        """Run the federation as a live service (``repro_torch.serve``) on
        the federation's device: client workers push uploads through a
        transport into a server hot loop driving the same algorithm
        objects as ``run()``.  ``driver="sequential"`` is the determinism
        bridge (bit-identical to ``run(mode="event")`` at
        ``buffer_size=1``); ``transport`` is a registry name ("inproc")
        or a ready ``Transport``.  ``retry``, ``exchange_timeout`` and
        ``liveness_timeout`` are the resilience knobs, ``stall_timeout``
        and ``recv_timeout`` bound the server's and the workers' waits;
        all are forwarded to ``serve_run``.  ``live`` (the HTTP telemetry
        plane) is not ported yet and raises when set."""
        if "num_clients" in overrides:
            raise ValueError("num_clients is fixed by the federation's data; it cannot be "
                             "overridden per run")
        if rounds is not None:
            overrides["rounds"] = rounds
        cfg = dataclasses.replace(self.config, **overrides) if overrides else self.config
        from repro_torch.serve import serve_run
        return serve_run(cfg, init_params_fn=self.init_params_fn, loss_fn=self.loss_fn,
                         fed_data=self.data, evaluate_fn=self.evaluate_fn,
                         client_eval_fn=self._client_eval_for(cfg), transport=transport,
                         driver=driver, pace=pace, speed=speed, stall_timeout=stall_timeout,
                         recv_timeout=recv_timeout, retry=retry,
                         exchange_timeout=exchange_timeout, liveness_timeout=liveness_timeout,
                         live=live, verbose=verbose, device=self.device, perm_fn=perm_fn)
