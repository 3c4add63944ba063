"""Host-side utilities (counterpart of bliss_tpu/utils/): the bucket
lengths and `profiling` (the span recorder of the program's steps, a
device trace that holds them, /proc readers).

`bucket_length` is looked up on first use: `models.analyzer` records its
spans through `utils.profiling`, so loading this package may not import
the analyzer."""

__all__ = ["bucket_length"]


def __getattr__(name):
    if name == "bucket_length":
        from ..models.analyzer import bucket_length

        return bucket_length
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
