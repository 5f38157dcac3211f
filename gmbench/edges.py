"""The edge list a run hands both the program and the reference."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Edges:
    src: torch.Tensor    # [E] int32
    dst: torch.Tensor    # [E] int32
    lens: torch.Tensor   # [E] int32, each edge's length (sssp's ``len``)
    num_nodes: int
    labels: Optional[torch.Tensor] = None   # [N]: node i of the structure's label

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())


def uniform_lengths(count: int, low: int, high: int,
                    gen: torch.Generator, device) -> torch.Tensor:
    """[count] int32 uniform in ``[low, high]``."""
    return torch.randint(low, high + 1, (count,), generator=gen,
                         device=device, dtype=torch.int32)


@dataclasses.dataclass
class Sample:
    """One answer kept from the window for the check."""

    root: int
    answer: torch.Tensor   # [n_pad] on the host
    info: dict
