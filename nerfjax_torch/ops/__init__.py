"""Ops and kernels (counterpart of ``nerfjax/ops``)."""
