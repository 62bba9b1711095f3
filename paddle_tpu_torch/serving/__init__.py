"""The serving plane of the port: the paged KV cache with its prefix
cache and its continuous-batching engine, the pinned-pool batcher and
speculative decoding (``paddle_tpu/serving`` without the daemon, router
and page shipping, which later slices port)."""

from .batcher import (SLO_CLASSES, ContinuousBatcher, Request,
                      SpeculativeDecoder, clip_emission,
                      prefix_resubmission_error, validate_request)
from .engine import Overloaded, ServingEngine
from .paged import PagedBatcher, PagePool
from .prefix import PrefixIndex

__all__ = ["SLO_CLASSES", "ContinuousBatcher", "Overloaded", "PagePool",
           "PagedBatcher", "PrefixIndex", "Request", "ServingEngine", "SpeculativeDecoder",
           "clip_emission", "prefix_resubmission_error", "validate_request"]
