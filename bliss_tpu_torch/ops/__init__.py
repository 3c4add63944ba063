"""Signal-processing primitives and kernel wrappers of the port."""
