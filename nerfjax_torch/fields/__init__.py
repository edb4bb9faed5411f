"""Neural fields (counterpart of ``nerfjax/fields``)."""
