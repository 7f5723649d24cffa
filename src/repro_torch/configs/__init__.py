"""Model configurations of the ported architectures (torch dtypes)."""
