"""CPU tests of the benchmark; the card tests are marked ``gpu``."""
