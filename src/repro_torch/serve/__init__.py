"""Serving (port of ``repro/serve``): the request gateway, its queues and
admission control, the prefix-cache index and the greedy ``ServeEngine``
over the dense/VLM LM substrate."""
from repro_torch.serve.admission import AdmissionController, RetryAfter
from repro_torch.serve.engine import (
    PrefixCacheIndex,
    Request,
    ServeEngine,
    prefix_fingerprints,
)
from repro_torch.serve.gateway import GatewayConfig, RequestGateway
from repro_torch.serve.queues import GatewayClosed, RequestFuture

__all__ = [
    "AdmissionController",
    "GatewayClosed",
    "GatewayConfig",
    "PrefixCacheIndex",
    "Request",
    "RequestFuture",
    "RequestGateway",
    "RetryAfter",
    "ServeEngine",
    "prefix_fingerprints",
]
