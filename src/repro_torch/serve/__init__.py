"""Serving without the LM (port of ``repro/serve``): the request gateway,
its queues and admission control, and the prefix-cache index.
``ServeEngine`` waits for the port's LM substrate."""
from repro_torch.serve.admission import AdmissionController, RetryAfter
from repro_torch.serve.engine import PrefixCacheIndex, prefix_fingerprints
from repro_torch.serve.gateway import GatewayConfig, RequestGateway
from repro_torch.serve.queues import GatewayClosed, RequestFuture

__all__ = [
    "AdmissionController",
    "GatewayClosed",
    "GatewayConfig",
    "PrefixCacheIndex",
    "RequestFuture",
    "RequestGateway",
    "RetryAfter",
    "prefix_fingerprints",
]
