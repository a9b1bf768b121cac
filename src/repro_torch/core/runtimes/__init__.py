# Algorithm-agnostic FL runtimes (port of repro.core.runtimes): the
# round-based runtime is the paper's Algorithm 1; the event runtime is
# the wall-clock asynchronous simulation (the sequential loop, and the
# round barrier for sync-barrier algorithms like fedavg).
from repro_torch.core.runtimes.events import run_event_driven  # noqa: F401
from repro_torch.core.runtimes.rounds import run_round_based  # noqa: F401
