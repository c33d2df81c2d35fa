"""Utilities: device selection, the kernel builder, logging, batching."""
