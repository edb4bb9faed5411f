"""The benchmark of ``nerfjax_torch`` on one NVIDIA H100 (see README.md)."""
