"""The serving plane of the port: the paged KV cache with its prefix
cache and its continuous-batching engine, the pinned-pool batcher,
speculative decoding, and the wire plane over the native RPC server —
the daemon (:class:`ServingDaemon`, :class:`PrefillDaemon`,
:class:`ServingClient`), KV-page shipping (``ship``) and the router
(:class:`ServingRouter`, :class:`RouterClient`)."""

from .batcher import (SLO_CLASSES, ContinuousBatcher, Request,
                      SpeculativeDecoder, clip_emission,
                      prefix_resubmission_error, validate_request)
from .daemon import PrefillDaemon, ServingClient, ServingDaemon
from .engine import Overloaded, ServingEngine
from .paged import PagedBatcher, PagePool
from .prefix import PrefixIndex
from .router import RouterClient, ServingRouter
from .ship import ShipError

__all__ = ["SLO_CLASSES", "ContinuousBatcher", "Overloaded", "PagePool",
           "PagedBatcher", "PrefixIndex", "Request", "ServingEngine",
           "SpeculativeDecoder", "clip_emission", "prefix_resubmission_error",
           "validate_request", "ServingDaemon", "ServingClient",
           "PrefillDaemon", "ServingRouter", "RouterClient", "ShipError"]
