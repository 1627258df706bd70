"""Checkpointing of the port's sampler."""
