"""Pluggable update compression (port of ``repro.compress``).
Importing this package registers the ported codecs; ``get_codec`` is the
entry point the runtimes use."""
from repro_torch.compress.base import (Codec, IdentityCodec, Payload,  # noqa: F401
                                       get_codec, register)
from repro_torch.compress.composed import TopKQuantCodec  # noqa: F401
from repro_torch.compress.error_feedback import (ErrorFeedback,  # noqa: F401
                                                 compress_update)
from repro_torch.compress.quantize import QuantCodec  # noqa: F401
from repro_torch.compress.sparsify import TopKCodec  # noqa: F401
