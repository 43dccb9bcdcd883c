"""Aho-Corasick multi-pattern counting automaton, built on the host.

Counterpart of ``multithreading_string_matching_tpu/models/aho_corasick.py``
(numpy only; that module cannot be imported without the JAX package's
``__init__``).  :meth:`AhoCorasick.build` gives arrays equal to the JAX
package's, state numbering included: the same trie insertion order and the
same breadth-first failure closure, so carried states (a flow monitor's
checkpoint) mean the same state in both packages.

- ``goto``  int32[S+1, 256]: failure-closed transitions; row S is a dead
  self-loop state.
- ``emit``  int32[S+1, U]: ``emit[s, u] == 1`` iff unique pattern u ends at
  state s (suffix outputs included); row S is zero.
- ``dup_map`` int32[P]: pattern-file index -> unique index.

Counts of the overlapping occurrences of pattern u are the number of
scanned positions whose state emits u (ops/scan.py).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

ALPHABET = 256


@dataclass(frozen=True)
class AhoCorasick:
    goto: np.ndarray        # int32[S+1, 256], failure-closed; row S = dead self-loop
    emit: np.ndarray        # int32[S+1, U]   pattern-end indicators
    dup_map: np.ndarray     # int32[P]        original -> unique index
    patterns: Tuple[bytes, ...]         # original pattern list (duplicates kept)
    unique_patterns: Tuple[bytes, ...]  # deduplicated, first-occurrence order

    @property
    def num_states(self) -> int:
        return int(self.goto.shape[0]) - 1

    @property
    def dead_state(self) -> int:
        return int(self.goto.shape[0]) - 1

    @property
    def emitting_states(self) -> np.ndarray:
        """Indices of states with at least one pattern ending there."""
        return np.nonzero(self.emit.sum(axis=1) > 0)[0].astype(np.int32)

    def expand_counts(self, unique_counts: np.ndarray) -> np.ndarray:
        """Map per-unique-pattern counts back to the original (duplicated) list."""
        return np.asarray(unique_counts)[..., self.dup_map]

    @staticmethod
    def build(patterns: Sequence[bytes]) -> "AhoCorasick":
        pats = [bytes(p) for p in patterns]
        if not pats:
            raise ValueError("no patterns")
        if any(len(p) == 0 for p in pats):
            raise ValueError("empty pattern")

        uniq: List[bytes] = []
        index: Dict[bytes, int] = {}
        dup_map = np.zeros(len(pats), dtype=np.int32)
        for i, p in enumerate(pats):
            if p not in index:
                index[p] = len(uniq)
                uniq.append(p)
            dup_map[i] = index[p]

        # Trie: states numbered in insertion order.
        children: List[Dict[int, int]] = [{}]
        terminal: List[List[int]] = [[]]
        for u, p in enumerate(uniq):
            s = 0
            for c in p:
                nxt = children[s].get(c)
                if nxt is None:
                    nxt = len(children)
                    children[s][c] = nxt
                    children.append({})
                    terminal.append([])
                s = nxt
            terminal[s].append(u)

        S = len(children)
        goto = np.zeros((S + 1, ALPHABET), dtype=np.int32)
        emit = np.zeros((S + 1, len(uniq)), dtype=np.int32)
        fail = np.zeros(S, dtype=np.int32)
        for s, us in enumerate(terminal):
            for u in us:
                emit[s, u] = 1

        # Breadth-first failure links and the failure closure of goto, a row
        # at a time: a state's row is its failure state's row (already
        # final: it is shallower) with its own children written over it.
        # Children enter the queue in byte order, as in the JAX package.
        q: deque = deque()
        for c, nxt in sorted(children[0].items()):
            goto[0, c] = nxt
            q.append(nxt)   # fail[nxt] = 0
        while q:
            s = q.popleft()
            f = fail[s]
            emit[s] |= emit[f]   # suffix outputs accumulate down the BFS
            goto[s] = goto[f]
            for c, nxt in sorted(children[s].items()):
                fail[nxt] = goto[f, c]
                goto[s, c] = nxt
                q.append(nxt)

        goto[S, :] = S  # dead state: self-loop, zero emit

        return AhoCorasick(
            goto=goto,
            emit=emit,
            dup_map=dup_map,
            patterns=tuple(pats),
            unique_patterns=tuple(uniq),
        )
