"""Measurement entry points of the torch package (``python -m ...tools.<name>``)."""
