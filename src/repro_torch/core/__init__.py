# The VAFL core (port of repro.core): Eq. 1 value, aggregation, local
# training, metrics, config, the round and event runtimes, the scheduler
# and the Federation facade.
from repro_torch.core import aggregation, client, metrics, value  # noqa: F401
from repro_torch.core.config import FLRunConfig  # noqa: F401
from repro_torch.core.federation import Federation  # noqa: F401
from repro_torch.core.runtimes import run_event_driven, run_round_based  # noqa: F401
