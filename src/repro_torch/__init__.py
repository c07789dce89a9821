"""PyTorch/CUDA port of the streaming-parallelism reproduction.

Laid out module for module like the JAX package ``repro``, which stays the
reference the port is held against.  This package imports ``torch`` and
never ``jax`` or anything of ``repro``.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; on a machine
without CUDA they raise instead of carrying on there.
"""
