"""Distributed execution of compiled Green-Marl programs over a mesh.

Counterpart of ``green_marl_tpu/lang/distribute.py`` (the ``replicate``
placement; the reference's GPS/Giraph backends, ``src/backend_gps/``): the
same lowered program runs once per shard (``parallel.comm.shard_map``) with

* the edge arrays (CSR/CSC slot arrays and edge properties) cut into equal
  slabs over a mesh axis (Shoal's array distribution, ``run.sh:66-105``),
* node properties and scalars replicated (the GPS "master" state),
* every edge-space reduction finished with ``psum``/``pmin``/``pmax`` over
  the axis, inserted by the ``Lowerer`` built with ``axis=``.

Random-access reads (``HasEdgeTo``), DFS and foreign text are rejected
(``gm_gps_new_check_random_read.cc``), as the JAX package rejects them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..graph.csr import Graph, round_up
from ..parallel.comm import Mesh, P, shard_map, vmesh
from .lower import _F, _RET, CompiledProc, Lowerer

_EDGE_FIELDS = ("node_idx", "node_idx_src", "r_node_idx",
                "r_node_idx_dst", "e_rev2idx")
_NODE_FIELDS = ("begin", "r_begin")


def pad_edges_for(g: Graph, num_shards: int) -> Graph:
    """Pad every [E_pad] array to ``num_shards`` equal slabs (sentinel fill,
    a junk row), so that each shard gets an equal slab."""
    e_pad = g.e_pad
    e_s = round_up(-(-e_pad // num_shards))
    tot = e_s * num_shards
    if tot == e_pad:
        return g
    fills = {"node_idx": g.num_nodes, "node_idx_src": g.num_nodes,
             "r_node_idx": g.num_nodes, "r_node_idx_dst": g.num_nodes,
             "e_rev2idx": 0}
    return dataclasses.replace(g, **{
        f: torch.nn.functional.pad(getattr(g, f), (0, tot - e_pad),
                                   value=fills[f]) for f in _EDGE_FIELDS})


def run_sharded(cp: CompiledProc, g: Graph, *args,
                mesh: Optional[Mesh] = None, axis: str = "v",
                **kwargs) -> Dict:
    """Execute ``cp`` with the edge arrays sharded over ``mesh[axis]``.

    The call convention and results of ``cp(g, *args, **kwargs)``: node
    properties and scalars come back replicated (rank 0's), edge properties
    in their CSR slot order, padded to the slabs' total."""
    if mesh is None:
        mesh = vmesh(None, axis, g.device.type)
    num_shards = mesh.shape[axis]
    g = pad_edges_for(g, num_shards)
    e_s = g.e_pad // num_shards

    # edge-property arguments ride the sharded spec
    lw0 = Lowerer(cp.proc, g)
    edge_kwargs = {}
    for k in list(kwargs):
        if k in lw0.props and lw0.props[k][0] == "E":
            arr = torch.as_tensor(kwargs.pop(k), device=g.device)
            if arr.shape[0] != g.e_pad:
                arr = torch.nn.functional.pad(arr, (0, g.e_pad - arr.shape[0]))
            edge_kwargs[k] = arr
    edge_arrays = {f: getattr(g, f) for f in _EDGE_FIELDS}
    node_arrays = {f: getattr(g, f) for f in _NODE_FIELDS}

    def body(axes, edge, node, a, kw, ekw):
        ax = axes[axis]
        gl = dataclasses.replace(g, **edge, **node,
                                 e_base=ax.index() * e_s)
        lw, env, out_names = cp._bind(gl, a, {**kw, **ekw}, axis=ax)
        lw.run(env)
        rep, sharded = {}, {}
        for name in out_names:
            v = env.get(_F + name, env.get(name))
            if name in lw.props and lw.props[name][0] == "E":
                sharded[name] = v
            else:
                rep[name] = v
        if _RET in env:
            rep["_return"] = env[_RET]
        return rep, sharded

    rep, sharded = shard_map(
        body, mesh, (P(axis), P(), P(), P(), P(axis)),
        (P(), P(axis)))(edge_arrays, node_arrays, args, kwargs, edge_kwargs)
    return {**rep, **sharded}
