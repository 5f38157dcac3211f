"""Plain PyTorch references of the benchmark's queries.

They work from the edge list (sources, destinations, lengths) that the
benchmark hands both sides, never from the CSR the program is given, and
import nothing of the program: what they share with it is the semantics of
the Green-Marl apps (``pagerank.gm``, ``hop_dist.gm``, ``sssp.gm``) and of
a level-synchronous BFS.  Each runs on whatever device its tensors are on,
in int64 or float64 unless asked for less.
"""
