"""One module a user entry that a window drives: setup, window, probes."""
