"""Host-built automata: the Aho-Corasick automaton and the per-pattern KMP
DFAs (numpy copies of the JAX package's ``models``)."""
