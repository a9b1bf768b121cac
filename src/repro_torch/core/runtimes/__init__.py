# Algorithm-agnostic FL runtimes (port of repro.core.runtimes): the
# round-based runtime is the paper's Algorithm 1; the event runtimes
# are not ported yet.
from repro_torch.core.runtimes.rounds import run_round_based  # noqa: F401
