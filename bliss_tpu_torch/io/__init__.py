"""Host-side ingest: the FFI-free decoders, batching, CUE splitting."""
