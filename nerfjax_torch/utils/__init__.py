"""Host utilities of the port (counterpart of ``nerfjax/utils``; its JAX
compilation cache has none: the port's kernels are cached by ``_build``,
which names each library by a hash of its source and flags)."""
