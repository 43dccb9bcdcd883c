"""Frozen input generators: rule sets, captures, and the stand-in pattern file."""
