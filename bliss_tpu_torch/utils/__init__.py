"""Host-side utilities (counterpart of bliss_tpu/utils/): the bucket
lengths and `profiling` (stage timers, a device trace)."""

from ..models.analyzer import bucket_length

__all__ = ["bucket_length"]
