"""The kNN graphs that the program selects, taken where it selects them.

The program's EdgeConv stages select their neighbours in one of two
calls: ``models.layers.knn_edge`` (kernel B1, on the card) or
``ops.neighbors.knn_gather`` (its plain route, on the CPU); both return
the graph (int32 [B, N, k]) first. :class:`GraphTap` wraps both while it
is open and, while ``on``, keeps every graph they return, in call order
(the transform net's first, then the stages'), without a copy or a
synchronise. The reference follows these graphs and checks them
(reference/dgcnn.py).
"""

from __future__ import annotations

from typing import List

import torch


class GraphTap:
    def __init__(self):
        from weaksuppointcloudseg_tpu_torch.models import layers
        from weaksuppointcloudseg_tpu_torch.ops import neighbors

        self.on = False
        self.graphs: List[torch.Tensor] = []
        targets = ((layers, "knn_edge"), (neighbors, "knn_gather"))
        self._saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._wrap(fn))

    def _wrap(self, fn):
        def tapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.on:
                self.graphs.append(out[0])
            return out
        return tapped

    def take(self) -> List[torch.Tensor]:
        """The graphs kept since the last take."""
        out, self.graphs = self.graphs, []
        return out

    def close(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self.graphs = []


def by_stage(graphs: List[torch.Tensor], stages: int) -> List[torch.Tensor]:
    """Graphs taken over forwards of chunks of one batch, each forward's
    ``stages`` graphs in order, joined per stage along the clouds."""
    if not graphs or len(graphs) % stages:
        raise ValueError(f"{len(graphs)} graphs for {stages} stages")
    return [torch.cat(graphs[s::stages]) for s in range(stages)]


def stages(model: dict) -> int:
    """The graphs one forward of ``model`` selects."""
    return len(model["edge_channels"]) + bool(model["use_transform_net"])
