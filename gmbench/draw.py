"""Everything a run draws from a seed, and the general traffic generator
that reads a traffic file.

Each use of a seed has a stream of its own (``generator``).  A
configuration's ``structure_seed`` draws its graph, its edge lengths and
the root set: one deployment's data, the same in every run.  The run's
``--seed`` draws the node labels (``graphs/*.py``) and the order of the
queries, and so which answers are checked: every seed does the same work
in another order on another layout, and the check after the window can
draw the edge list again.

A traffic file (``traffic/<name>.json``) holds::

    {"loop": "closed", "clients": 1,
     "kinds": [{"kind": "pagerank", "share": 1, "args": {...}}, ...],
     "order": "shuffled" | "alternating",
     "roots": {"min_out_degree": 1, "count": 64},
     "queries": 4096,
     "warmup": 1,
     "check": {"every": 16, "max": 48}}

``queries`` is the length of the plan drawn before the window; a window
that outlasts it starts the plan again.  ``order``: ``shuffled`` cuts the
plan into blocks that each hold every kind in its share, each block in a
seeded order, so that every seed sends the same mix at any length and
only the order differs; ``alternating`` takes the kinds in turn.  The
roots are ``count`` distinct nodes drawn uniformly among those with
``min_out_degree`` out-edges or more, from the configuration's structure
seed, so every seed has the same root set under its own labels; each
rooted kind takes them over and over in a seeded order of its own.  The
check compares the query at every ``every``-th position (from a seeded
offset) and the first of each kind, at most ``max`` of them.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Tuple

import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of run seed ``seed`` (any whole number)."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


@dataclasses.dataclass
class Plan:
    """The queries of a run, drawn before its window."""

    kinds: List[str]            # kind of query i
    roots: List[int]            # root of query i (ignored by rootless kinds)
    warmup: List[Tuple[str, int]]
    checked: List[bool]         # whether query i's answer is compared
    args: Dict[str, Dict[str, Any]]   # kind -> its arguments


def plan(traffic: Dict[str, Any], out_degree: torch.Tensor,
         labels: torch.Tensor, structure_seed: int, seed: int) -> Plan:
    """The query plan of ``traffic`` over a graph whose real nodes have
    ``out_degree`` ([N], any device) and whose structure's node ``i`` has
    the label ``labels[i]``."""
    if traffic.get("loop", "closed") != "closed" or \
            int(traffic.get("clients", 1)) != 1:
        raise ValueError("the generator runs one client in a closed loop")
    g = generator(seed, "traffic", "cpu")
    kinds = [k["kind"] for k in traffic["kinds"]]
    if len(set(kinds)) != len(kinds):
        raise ValueError(f"a kind is listed twice: {kinds}")
    q = int(traffic["queries"])
    if traffic["order"] == "alternating":
        order = [kinds[i % len(kinds)] for i in range(q)]
    elif traffic["order"] == "shuffled":
        shares = [int(k.get("share", 1)) for k in traffic["kinds"]]
        block = [k for k, s in zip(kinds, shares) for _ in range(s)]
        order = []
        while len(order) < q:
            perm = torch.randperm(len(block), generator=g).tolist()
            order += [block[i] for i in perm]
        order = order[:q]
    else:
        raise ValueError(f"order {traffic['order']!r}: shuffled or "
                         f"alternating")
    roots = root_set(traffic["roots"], out_degree, labels, structure_seed)
    per_kind = {k: [roots[i] for i in
                    torch.randperm(len(roots), generator=g).tolist()]
                for k in kinds}
    seen: Dict[str, int] = {}
    plan_roots = []
    for k in order:
        plan_roots.append(per_kind[k][seen.get(k, 0) % len(roots)])
        seen[k] = seen.get(k, 0) + 1
    warmup = [(k, per_kind[k][-1 - w % len(roots)])
              for w in range(int(traffic.get("warmup", 1))) for k in kinds]
    every = int(traffic["check"]["every"])
    offset = int(torch.randint(every, (1,), generator=g))
    checked, first = [], set()
    for i, k in enumerate(order):
        checked.append(i % every == offset or k not in first)
        first.add(k)
    cap = int(traffic["check"]["max"])
    for i in [i for i, c in enumerate(checked) if c][cap:]:
        checked[i] = False
    args = {k["kind"]: dict(k.get("args", {})) for k in traffic["kinds"]}
    return Plan(kinds=order, roots=plan_roots, warmup=warmup,
                checked=checked, args=args)


def root_set(rule: Dict[str, Any], out_degree: torch.Tensor,
             labels: torch.Tensor, structure_seed: int) -> List[int]:
    """``rule["count"]`` distinct roots among the nodes with at least
    ``rule["min_out_degree"]`` out-edges, drawn in the structure's node
    ids from its seed and returned under the run's ``labels``."""
    ok = out_degree.index_select(0, labels) >= int(rule["min_out_degree"])
    eligible = torch.nonzero(ok).flatten()
    count = int(rule["count"])
    if eligible.numel() < count:
        raise ValueError(f"{eligible.numel()} nodes are eligible as roots, "
                         f"{count} asked for")
    g = generator(structure_seed, "roots", "cpu")
    picked: Dict[int, None] = {}
    while len(picked) < count:
        for i in torch.randint(eligible.numel(), (2 * count,),
                               generator=g).tolist():
            picked.setdefault(i, None)
    chosen = torch.tensor(list(picked)[:count], device=eligible.device)
    return labels.index_select(0, eligible.index_select(0, chosen)).tolist()
