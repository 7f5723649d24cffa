"""Backend language models of the port (ported families only)."""
