"""``repro_torch.serve``: the federation as a live service.  Port of
``repro.serve``.

The closed-loop runtimes simulate asynchrony; this package hosts it:
client workers (threads or processes) push versioned, compressed
uploads through a pluggable transport into a server hot loop that
drives the SAME algorithm, aggregator and codec objects and, through
the determinism bridge (``driver="sequential"``, ``buffer_size=1``),
gives results bit-identical to the simulation.

    from repro_torch.serve import serve_run
    res = serve_run(cfg, init_params_fn=..., loss_fn=...,
                    fed_data=data, evaluate_fn=..., device="cuda")

Transports live behind a string registry (``get_transport`` /
``register_transport``): ``inproc``, ``socket`` (``SocketTransport``,
localhost TCP for ``ProcessClientWorker``) and ``chaos``
(``repro_torch.resilience.ChaosTransport``).
"""
from repro_torch.serve.client import (ClientCompute, ProcessClientWorker, ScenarioPacer,
                                      SequentialDriver, ThreadClientWorker)
from repro_torch.serve.messages import (MAGIC, MAX_FRAME_BYTES, WIRE_SCHEMA, BroadcastMsg,
                                        UploadMsg, WireError, msg_from_wire, msg_to_wire)
from repro_torch.serve.multitenant import MultiTenantServer
from repro_torch.serve.run import DRIVERS, launch_serving, resolve_live, serve_run
from repro_torch.serve.server import FLServer
from repro_torch.serve.transport import (ClientChannel, InprocTransport, Transport,
                                         available_transports, get_transport,
                                         register_transport)

__all__ = [
    "WIRE_SCHEMA", "MAGIC", "MAX_FRAME_BYTES", "WireError", "UploadMsg", "BroadcastMsg",
    "msg_to_wire", "msg_from_wire", "Transport", "ClientChannel", "InprocTransport",
    "get_transport", "register_transport", "available_transports", "FLServer",
    "ClientCompute", "ThreadClientWorker", "ProcessClientWorker", "SequentialDriver",
    "ScenarioPacer", "MultiTenantServer", "serve_run", "launch_serving", "resolve_live",
    "DRIVERS",
]
