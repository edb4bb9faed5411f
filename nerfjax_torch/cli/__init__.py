"""Command-line tools of the port (counterpart of ``nerfjax/cli``)."""
