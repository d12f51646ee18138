"""Checkpointing of the port (counterpart of the JAX package's
``checkpoint``)."""
