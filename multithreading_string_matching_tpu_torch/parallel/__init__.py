"""Streaming and multi-device execution on PyTorch (``flow_stream`` so far)."""
