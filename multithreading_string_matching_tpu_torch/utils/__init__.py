"""Phase timers and compat reporting."""
