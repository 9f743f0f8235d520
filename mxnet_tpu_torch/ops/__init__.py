"""Operators of the port. :mod:`.attention` holds the flash prefill and
paged decode ops with their hand-written CUDA kernels; :mod:`._build`
compiles and binds those kernels."""
