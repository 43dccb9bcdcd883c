"""Phase timers, compat reporting and the run configuration (``MatchConfig``)."""
