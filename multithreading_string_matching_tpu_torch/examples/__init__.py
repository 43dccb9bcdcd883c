"""Worked examples on the port: ``ids_demo`` (an IDS-style alerter) and
``flow_ids_demo`` (flow-aware alerting), the twins of the JAX package's
``examples/``."""
