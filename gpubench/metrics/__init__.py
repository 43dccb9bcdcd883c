"""Per-layer metric readers, named as in BENCHMARK.json: the reader of
``<name>.<cell kind>`` is ``<name>.<cell kind>.py`` where that file exists,
else ``<name>.py``.  ``read(records)`` gives the metric's value, or ``None``
where the records hold nothing to read."""
