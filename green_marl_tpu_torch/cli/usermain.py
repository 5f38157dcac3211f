"""Default usermain: graph in, run the procedure, results out.

Counterpart of ``green_marl_tpu/cli/usermain.py`` (the reference's
``gm_default_usermain.cc``): BIN, EBIN, EDGE, ADJ and AVRO
input, local or staged from ``hdfs://`` / ``gs://`` (``graph.fs``); with
``-GMDumpGraph=1`` and an ``OutputName`` the graph and the output
properties are written as ``-GMOutputFormat`` says (BIN, NULL, EBIN, EDGE,
NODE_PROP, AVRO).  It prints the stdout protocol the verification harness
reads (``scripts/extract_result.py``):

* ``graph loading time=<ms>`` and ``reverse edge creation time=<ms>``;
* ``running time=<ms>`` with ``-GMMeasureTime`` (the algorithm only, after
  one warm-up run; the timed region ends once the result is on the host);
* ``<name>[i] = <value>`` for the leading values of each output;
* ``CRC <array> 0x........`` (zlib CRC-32) and ``CRC16 <array> 0x....``;
* ``superstep[i] time=<ms>`` with ``-GMProfile`` (pagerank and hop_dist).

``-GMDevice`` (default ``cuda``) picks the torch device.  Without CUDA,
``-GMDevice=cuda`` exits with an error: it never drops to the CPU.
``-GMNumChips=k`` runs pagerank, hop_dist, sssp, conduct, avg_teen_cnt and
``.gm`` files on k shards (``cli.apps``, ``-GMPlacement``): k devices of
``-GMDevice``'s kind, or fewer with ``GM_TORCH_VIRTUAL_DEVICES`` shards on
each.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graph import avro_io, fs
from ..graph import binary_io as bio
from ..graph import edge_list as el
from ..graph.csr import Graph, from_edges
from ..utils.crc import array_checksum_hex, crc16_hex
from .useropt import UserOpt

GM_NODEPROP = "node"
GM_EDGEPROP = "edge"
GM_SCALAR = "scalar"

_TYPE_NAMES = {
    bio.GMTYPE_BOOL: bool, bio.GMTYPE_INT: int, bio.GMTYPE_LONG: int,
    bio.GMTYPE_FLOAT: float, bio.GMTYPE_DOUBLE: float,
    bio.GMTYPE_NODE: int, bio.GMTYPE_EDGE: int,
}

@dataclass
class Schema:
    name: str
    type: int              # VALUE_TYPE
    is_input: bool
    is_output: bool
    kind: str              # node/edge/scalar
    dump_count: int = 0    # per-app print count (0 = use -GMDumpValues)


@dataclass
class RunContext:
    graph: Graph
    csr_perm: np.ndarray                # input edge index of each CSR slot
    node_props: Dict[str, np.ndarray]
    edge_props: Dict[str, np.ndarray]   # CSR slot order
    scalars: Dict[str, Any]
    nodekey: Optional[np.ndarray] = None    # dense id -> the file's key
    # device tensors (and graphs) an app keeps between runs, by name, so
    # that the warm-up run of -GMMeasureTime pays for their upload (the
    # reference prepares its inputs in prepare(), outside the timed region)
    device_props: Dict[str, Any] = field(default_factory=dict)
    options: Optional[UserOpt] = None       # the parsed flags


def resolve_device(name: str) -> torch.device:
    """The torch device for ``-GMDevice``; exits when it is unusable."""
    try:
        dev = torch.device(name)
    except RuntimeError:
        raise SystemExit(f"-GMDevice={name}: not a torch device")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"-GMDevice={name}: no CUDA device is "
                             "available (-GMDevice=cpu runs the plain "
                             "PyTorch versions on the CPU)")
    elif dev.type != "cpu":
        raise SystemExit(f"-GMDevice={name}: only cpu and cuda are "
                         "supported")
    return dev


class UserMain:
    """Declarative app driver, one per algorithm (see ``cli.apps``)."""

    def __init__(self, proc_name: str, desc: str = ""):
        self.proc_name = proc_name
        self.schemas: List[Schema] = []
        self.defaults: Dict[str, Any] = {}
        self.run_fn: Optional[Callable[[RunContext], Dict[str, Any]]] = None
        self.O = UserOpt(proc_name, desc)
        self.O.add_option("GMMeasureTime", bool, "0", "Measure running time")
        self.O.add_option("GMDevice", str, "cuda",
                          "Torch device: cuda, cuda:<i> or cpu")
        self.O.add_option("GMProfile", bool, "0",
                          "Per-superstep device timing + per-array "
                          "report (pagerank, hop_dist)")
        self.O.add_option("GMInputFormat", str, "BIN",
                          "ADJ|EDGE|BIN|EBIN|AVRO")
        self.O.add_option("GMOutputFormat", str, "NULL",
                          "BIN|EBIN|EDGE|NODE_PROP|AVRO|NULL")
        self.O.add_option("GMNumChips", int, None,
                          "Number of shards (mesh size); more shards than "
                          "devices need GM_TORCH_VIRTUAL_DEVICES")
        self.O.add_option("GMPlacement", str, "distribute",
                          "Sharded-run array placement policy: "
                          "'distribute' = vertex-sharded O(N/S) owned "
                          "state + ghost all_to_all; 'replicate' = "
                          "replicated node state + psum combine (the "
                          "Shoal -d vs baseline configs, run.sh:66-105); "
                          "'engine' = the hand-written vertex-sharded "
                          "supersteps")
        self.O.add_option("GMPlace", str, None,
                          "Per-array placement override(s), "
                          "'arr:policy[,arr:policy...]' with policy "
                          "replicate|distribute (Shoal "
                          "local_array_settings.lua analog, "
                          "run.sh:218-246)")
        self.O.add_option("GMPlacementFile", str, None,
                          "JSON file {\"arr\": \"policy\", ...} of "
                          "per-array placement overrides "
                          "(generate_settings.py analog)")
        self.O.add_option("GMNumThreads", int, None,
                          "Accepted for reference-CLI compatibility")
        self.O.add_option("GMDumpGraph", int, "0",
                          "1: write output graph/props file")
        self.O.add_option("GMDumpValues", int, "4",
                          "How many leading output values to print")
        self.O.add_argument("InputName", "Input graph filename")
        self.O.add_argument("OutputName", "[optional] Output filename")

    # -- declarations ----------------------------------------------------
    def declare_scalar(self, name, t, is_input, is_output, default=None):
        self.schemas.append(Schema(name, t, is_input, is_output, GM_SCALAR))
        if default is not None:
            self.defaults[name] = default
        if is_input:
            self.O.add_option(name, _TYPE_NAMES[t],
                              None if default is None else str(default),
                              "input argument")

    def declare_property(self, name, t, is_input, is_output, kind,
                         dump_count: int = 0):
        self.schemas.append(Schema(name, t, is_input, is_output, kind,
                                   dump_count))

    def set_run(self, fn):
        self.run_fn = fn

    # -- pipeline --------------------------------------------------------
    def _check_placement(self) -> None:
        """Per-array overrides act only on the sharded distribute path: a
        single-device run would silently ignore them, so it exits (as the
        JAX CLI does).  ``-GMPlacement`` alone changes nothing on one
        device."""
        opt = self.O.get_option
        if ((opt("GMPlace") or opt("GMPlacementFile"))
                and int(opt("GMNumChips") or 1) <= 1):
            raise SystemExit(
                "-GMPlace/-GMPlacementFile require -GMNumChips>1 "
                "(they pin arrays of the distributed placement)")

    def load(self, device: torch.device) -> RunContext:
        fmt = self.O.get_option("GMInputFormat").upper()
        path = self.O.get_arg(0)
        if path is None:
            self.O.print_help()
            raise SystemExit(1)
        path = fs.fetch(path)   # hdfs:// and gs:// staged locally
        in_nprops = [s for s in self.schemas
                     if s.kind == GM_NODEPROP and s.is_input]
        in_eprops = [s for s in self.schemas
                     if s.kind == GM_EDGEPROP and s.is_input]
        nodekey = None
        nprop_arrays: List[np.ndarray] = []
        eprop_arrays: List[np.ndarray] = []
        if fmt in ("BIN", "EBIN"):
            raw = bio.load_binary(path)
            g, perm = raw.freeze()
            nodekey = raw.nodekey
            nprop_arrays = raw.node_props
            eprop_arrays = [p[perm] for p in raw.edge_props]
        elif fmt == "EDGE":
            res = el.load_edge_list(path, [s.type for s in in_nprops],
                                    [s.type for s in in_eprops])
            g, eprop_arrays = res.freeze()
            perm = np.arange(g.num_edges)
            nodekey = res.nodekey
            nprop_arrays = res.node_props
        elif fmt == "ADJ":
            g, perm = from_edges(*el.load_adjacency_list(path))
        elif fmt == "AVRO":
            # the Avro object container (gm_graph_avro_loader.cc)
            src, dst, nprop_arrays, eav, _, _, nn = avro_io.load_avro(path)
            g, perm = from_edges(src.astype(np.int32), dst.astype(np.int32),
                                 nn)
            eprop_arrays = [np.asarray(p)[perm] for p in eav]
        else:
            raise SystemExit(f"unknown input format {fmt}")
        g = g.to(device)
        ctx = RunContext(graph=g, csr_perm=perm, node_props={},
                         edge_props={}, scalars={}, nodekey=nodekey,
                         options=self.O)
        for s, arr in zip(in_nprops, nprop_arrays):
            ctx.node_props[s.name] = arr
        for s, arr in zip(in_eprops, eprop_arrays):
            ctx.edge_props[s.name] = arr
        where = (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "host")
        print("# loaded: N=%d E=%d fmt=%s node_props=[%s] edge_props=[%s] "
              "device=%s (%s)" % (
                  g.num_nodes, g.num_edges, fmt, ",".join(ctx.node_props),
                  ",".join(ctx.edge_props), device, where), file=sys.stderr)
        for s in self.schemas:
            if s.kind == GM_SCALAR and s.is_input:
                v = self.O.get_option(s.name)
                if v is None and s.name in self.defaults:
                    v = self.defaults[s.name]
                ctx.scalars[s.name] = v
        return ctx

    def main(self, argv: Optional[Sequence[str]] = None) -> int:
        argv = list(sys.argv[1:] if argv is None else argv)
        if not self.O.parse(argv):
            return 1
        self._check_placement()
        device = resolve_device(self.O.get_option("GMDevice"))
        if self.run_fn is None:
            raise RuntimeError("set_run() not called")
        t0 = time.time()
        ctx = self.load(device)
        t1 = time.time()
        print(f"graph loading time={1000 * (t1 - t0):f}")
        # reverse edges are built while loading; the line stays for the
        # stdout contract (common_main.h:181)
        print(f"reverse edge creation time={0.0:f}")

        measure = self.O.get_option("GMMeasureTime")
        if measure:
            # the timed run excludes the kernels' first-use build and the
            # allocator's warm-up: run once untimed, output suppressed
            with contextlib.redirect_stdout(io.StringIO()):
                self.run_fn(ctx)
        t2 = time.time()
        outputs = self.run_fn(ctx)   # host arrays: the device is done
        t3 = time.time()
        if measure:
            print(f"running time={1000 * (t3 - t2):f}")
        self.report(ctx, outputs)
        self.store(ctx, outputs)
        return 0

    # -- output protocol -------------------------------------------------
    def report(self, ctx: RunContext, outputs: Dict[str, Any]) -> None:
        k = self.O.get_option("GMDumpValues")
        for s in self.schemas:
            val = outputs.get(s.name)
            if val is None or not (s.is_output or s.name == "return"):
                continue
            if s.kind == GM_SCALAR:
                print(f"{self.proc_name} returns: {_fmt(val, s.type)}"
                      if s.name == "return"
                      else f"{s.name} = {_fmt(val, s.type)}")
                continue
            n = (ctx.graph.num_nodes if s.kind == GM_NODEPROP
                 else ctx.graph.num_edges)
            arr = np.asarray(val)[:n]
            for i in range(min(s.dump_count or k, n)):
                print(f"{s.name}[{i}] = {_fmt(arr[i], s.type)}")
            print(f"CRC {s.name} {array_checksum_hex(arr)}")
            print(f"CRC16 {s.name} {crc16_hex(arr)}")

    def store(self, ctx: RunContext, outputs: Dict[str, Any]) -> None:
        """``-GMDumpGraph=1``: write the graph and the output properties to
        ``OutputName`` in ``-GMOutputFormat`` (BIN and NULL: the graph
        alone), byte for byte as the JAX CLI does; a remote name is written
        locally first, then published."""
        if not self.O.get_option("GMDumpGraph"):
            return
        out = self.O.get_arg(1)
        if out is None:
            return
        fmt = self.O.get_option("GMOutputFormat").upper()
        dest = out
        if fs.is_remote(out):
            h = hashlib.sha1(out.encode()).hexdigest()[:10]
            out = os.path.join(tempfile.gettempdir(),
                               f"gmtpu_out_{h}_" + os.path.basename(out))
        g = ctx.graph
        begin = g.begin.cpu().numpy()
        node_idx = g.node_idx[: g.num_edges].cpu().numpy()
        props = {kind: [np.asarray(outputs[s.name])[: n]
                        for s in self.schemas if s.kind == kind
                        and s.is_output and s.name in outputs]
                 for kind, n in ((GM_NODEPROP, g.num_nodes),
                                 (GM_EDGEPROP, g.num_edges))}
        nprops, eprops = props[GM_NODEPROP], props[GM_EDGEPROP]
        if fmt in ("BIN", "NULL"):
            bio.store_binary(out, begin, node_idx)
        elif fmt == "EBIN":
            bio.store_binary(out, begin, node_idx, nodekey=ctx.nodekey,
                             node_props=nprops, edge_props=eprops)
        elif fmt == "EDGE":
            src = np.repeat(np.arange(g.num_nodes), np.diff(begin))
            el.store_edge_list(out, src, node_idx, nodekey=ctx.nodekey,
                               node_props=nprops, edge_props=eprops)
        elif fmt == "NODE_PROP":
            with open(out, "w") as f:
                for i in range(g.num_nodes):
                    row = " ".join(str(p[i]) for p in nprops)
                    f.write(f"{i} {row}\n")
        elif fmt == "AVRO":
            avro_io.store_avro(out, begin, node_idx, node_props=nprops,
                               edge_props=eprops)
        else:
            raise SystemExit(f"unknown output format {fmt}")
        if dest != out:
            fs.publish(out, dest)


def _fmt(v, t) -> str:
    if t in (bio.GMTYPE_FLOAT, bio.GMTYPE_DOUBLE):
        return f"{float(v):0.9f}"   # reference: printf("%0.9lf")
    if t == bio.GMTYPE_BOOL:
        return "true" if v else "false"
    return str(int(v))
