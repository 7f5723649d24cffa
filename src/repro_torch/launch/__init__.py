"""Prefill and decode steps for serving the backend language models."""
