"""The serving plane of the port: the paged KV cache and its
continuous-batching engine, the pinned-pool batcher and speculative
decoding (``paddle_tpu/serving`` without the daemon, router, prefix cache
and page shipping, which later slices port)."""

from .batcher import (SLO_CLASSES, ContinuousBatcher, Request,
                      SpeculativeDecoder, clip_emission,
                      prefix_resubmission_error, validate_request)
from .engine import Overloaded, ServingEngine
from .paged import PagedBatcher, PagePool

__all__ = ["SLO_CLASSES", "ContinuousBatcher", "Overloaded", "PagePool",
           "PagedBatcher", "Request", "ServingEngine", "SpeculativeDecoder",
           "clip_emission", "prefix_resubmission_error", "validate_request"]
