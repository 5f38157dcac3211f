"""Segment kernels on the card, at the LiveJournal-scale graph's pull shape.

Times ``kernels.segment_reduce_sorted`` (float32 add and int32 min),
``kernels.segmented_scan`` (float32 add) and ``kernels.plain_cumsum``
(int32, inclusive and exclusive) over the CSC of the RMAT graph of
bench.py's LiveJournal-scale sizes (N=4.8M, E=69M, seed 42, edges from
``native/gm_io.cc``), each beside its plain version and its bound
(``probes/bounds.py``), with a ``clone()`` of the values and, where one
PyTorch call computes the same function, that call
(``torch.segment_reduce``, ``torch.cumsum``: yardsticks only, the port
never calls them); then ``scan_reduce.segment_sum_by_offsets`` (BFS's pull
sweep: the exclusive scan) beside its earlier inclusive-scan-and-copy
form.  Then the segment reduce on the edge slab of the second of 4 shards
with its offsets clipped to the slab, as the replicate placement gives
them (``Graph.csc_offsets``: millions of empty rows at slot 0 and at the
slab's end), beside its plain version.  Each kernel is first held against
its plain version.  Times are CUDA events, per call
(``utils.timing.kernel_ms``): back-to-back launches in groups, the median
group and the range over the groups; a plain version one call a group.

``--lanes B`` times the lane-batched segment reduce instead, at the shape a
batched compiled program gives it: ``[B, E_pad]`` values (float32 add and
int32 min) over the same offsets, each lane first held against the 1-D
kernel on its row (bit for bit) and the whole against the plain version,
then timed beside B launches of the 1-D kernel, the plain version and
``torch.segment_reduce`` on the ``[E_pad, B]`` transpose (a yardstick: the
transpose itself is not timed); then the lane-batched exclusive prefix sum
(the form ``segment_sum_by_offsets`` launches for a batched program's
``Count``) at ``[B, E_pad]`` int32, checked the same way and timed beside
B one-row launches, its plain version and ``torch.cumsum``.  ``--ptxas``
prints what ``nvcc -Xptxas
-v`` says of each segment-reduce kernel (registers, spills, shared
memory) and exits.

Run on a machine with an NVIDIA GPU, from the root of a checkout::

    python green_marl_tpu_torch/probes/segment.py [--root DIR] [--lanes B]
    python green_marl_tpu_torch/probes/segment.py --ptxas

``--root DIR`` takes the package from another checkout (``DIR`` holds
``green_marl_tpu_torch/``), so two commits can be timed in turns within one
run on one card: both keep the wrappers' Python signatures.  ``--parts``
adds the segment reduce's device time launch by launch (``torch.profiler``:
the scratch clear, the row bounds, the tiles) at both shapes.  The graph's
CSC offsets are kept in ``--cache`` between runs.  Prints one JSON object
per line.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

LJ_N, LJ_E, LJ_SEED = 4_800_000, 69_000_000, 42   # bench.py:50-52
PLAIN_CALLS, PLAIN_GROUPS = 1, 3    # a plain version takes up to ~250 ms


def csc_offsets(native, cache):
    """[N + 1] int32 CSC offsets of the LJ-scale RMAT graph."""
    if cache and os.path.exists(cache):
        return np.load(cache)
    _, dst = native.rmat_edges(LJ_N, LJ_E, seed=LJ_SEED)
    off = np.zeros(LJ_N + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=LJ_N), out=off[1:])
    if cache:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.save(cache, off)
    return off


def time_all(args, K, record, vals_f, vals_i, ids, offs, n_pad, e_pad):
    """Times each kernel and its yardsticks, then the plain versions and
    the earlier form of ``segment_sum_by_offsets``; one record each."""
    from green_marl_tpu_torch.ops import scan_reduce
    from green_marl_tpu_torch.probes import bounds
    from green_marl_tpu_torch.utils.timing import kernel_ms
    offs64 = offs.long()
    bits = vals_i & 1
    reduce_bytes = bounds.segment_reduce(int(offs[-1]) - int(offs[0]),
                                         offs.numel(), n_pad)
    scan_bytes = bounds.segmented_scan(e_pad)
    cumsum_bytes = bounds.plain_cumsum(e_pad)
    excl_bytes = bounds.plain_cumsum(e_pad, exclusive=True)

    def sum_by_offsets_cat():
        """segment_sum_by_offsets as it was before the exclusive scan: the
        inclusive scan, then a copy of the prefix behind a 0."""
        ex = torch.cat([bits.new_zeros(1), K.plain_cumsum(bits)])
        return ex.index_select(0, offs[1:]) - ex.index_select(0, offs[:-1])

    kernels = (
        ("segment_reduce_sorted float32 add",
         lambda: K.segment_reduce_sorted(vals_f, ids, offs, n_pad, "add"),
         reduce_bytes),
        ("segment_reduce_sorted int32 min",
         lambda: K.segment_reduce_sorted(vals_i, ids, offs, n_pad, "min"),
         reduce_bytes),
        ("segmented_scan float32 add",
         lambda: K.segmented_scan(vals_f, ids, "add"), scan_bytes),
        ("plain_cumsum int32", lambda: K.plain_cumsum(vals_i), cumsum_bytes),
        ("plain_cumsum int32 exclusive",
         lambda: K.plain_cumsum(vals_i, exclusive=True), excl_bytes),
        ("torch.segment_reduce float32 sum (offsets)",
         lambda: torch.segment_reduce(vals_f, "sum", offsets=offs64),
         reduce_bytes),
        ("clone of the values", vals_f.clone, 8 * e_pad),
        ("torch.cumsum int32",
         lambda: torch.cumsum(vals_i, 0, dtype=torch.int32), cumsum_bytes),
        ("segment_sum_by_offsets int32 0/1",
         lambda: scan_reduce.segment_sum_by_offsets(bits, offs, n_pad), None),
        ("segment_sum_by_offsets int32 0/1: inclusive scan + copy (the "
         "form before)", sum_by_offsets_cat, None))
    plains = (
        ("segment_reduce_sorted float32 add: plain",
         lambda: K.segment_reduce_sorted_ref(vals_f, ids, offs, n_pad, "add"),
         reduce_bytes),
        ("segment_reduce_sorted int32 min: plain",
         lambda: K.segment_reduce_sorted_ref(vals_i, ids, offs, n_pad, "min"),
         reduce_bytes),
        ("segmented_scan float32 add: plain",
         lambda: K.segmented_scan_ref(vals_f, ids, "add"), scan_bytes),
        ("plain_cumsum int32: plain", lambda: K.plain_cumsum_ref(vals_i),
         cumsum_bytes),
        ("plain_cumsum int32 exclusive: plain",
         lambda: K.plain_cumsum_ref(vals_i, exclusive=True), excl_bytes))
    for group, calls, groups in ((kernels, args.calls, args.groups),
                                 (plains, PLAIN_CALLS, PLAIN_GROUPS)):
        for what, fn, nbytes in group:
            med, lo, hi = kernel_ms(fn, calls, groups)
            record(what=what, ms=med, ms_min=lo, ms_max=hi,
                   bound_ms=None if nbytes is None
                   else bounds.bound_ms(nbytes))


def parts(K, record, what, vals, offs, n_out, calls=20):
    """Device time of each launch inside one segment reduce, mean over
    ``calls`` calls (``torch.profiler``)."""
    from green_marl_tpu_torch.probes.gather import kernel_name
    from green_marl_tpu_torch.probes.profile_apps import device_times
    K.segment_reduce_sorted(vals, vals, offs, n_out, "add")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            K.segment_reduce_sorted(vals, vals, offs, n_out, "add")
        torch.cuda.synchronize()
    ms = {}
    for name, t in device_times(prof).items():
        ms[kernel_name(name)] = ms.get(kernel_name(name), 0.0) + t / calls
    record(what=f"{what}: launches", parts=ms)


def clipped_slab(args, K, record, vals_f, vals_i, offs, n_pad, e_pad):
    """The segment reduce on shard 1 of 4's slab with clipped offsets:
    checked against its plain version, then timed beside it."""
    from green_marl_tpu_torch.probes import bounds
    from green_marl_tpu_torch.utils.timing import kernel_ms
    e_s = -(-e_pad // 4)
    e_s = -(-e_s // 128) * 128                       # pad_edges_for's slab
    off = (offs - e_s).clamp(0, e_s)
    vf, vi = vals_f[:e_s], vals_i[:e_s]
    ids = vi                                         # shape only
    got = K.segment_reduce_sorted(vf, ids, off, n_pad, "add")
    want = K.segment_reduce_sorted_ref(vf.double(), ids, off, n_pad, "add")
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=0.0)
    for op in ("min", "max"):
        assert torch.equal(K.segment_reduce_sorted(vi, ids, off, n_pad, op),
                           K.segment_reduce_sorted_ref(vi, ids, off, n_pad,
                                                       op))
    deg = off.diff()
    record(what="clipped slab", e_s=e_s, n_seg=off.numel() - 1,
           empty_rows=int((deg == 0).sum()), ok=True)
    bound = bounds.bound_ms(bounds.segment_reduce(
        int(off[-1]) - int(off[0]), off.numel(), n_pad))
    for what, fn in (
            ("clipped slab: segment_reduce_sorted float32 add",
             lambda: K.segment_reduce_sorted(vf, ids, off, n_pad, "add")),
            ("clipped slab: segment_reduce_sorted int32 min",
             lambda: K.segment_reduce_sorted(vi, ids, off, n_pad, "min")),
            ("clipped slab: plain float32 add",
             lambda: K.segment_reduce_sorted_ref(vf, ids, off, n_pad,
                                                 "add"))):
        med, lo, hi = kernel_ms(fn, args.calls, args.groups)
        record(what=what, ms=med, ms_min=lo, ms_max=hi, bound_ms=bound)
    if args.parts:
        parts(K, record, "clipped slab float32 add", vf, off, n_pad)


def lanes(args, K, record, offs, n_pad, e_pad):
    """The lane-batched segment reduce at [B, E_pad]: checked, then timed
    beside B one-row launches, the plain version and one PyTorch call;
    then the lane-batched exclusive prefix sum the same way."""
    from green_marl_tpu_torch.probes import bounds
    from green_marl_tpu_torch.utils.timing import kernel_ms
    b = args.lanes
    dev = offs.device
    gen = torch.Generator(device=dev).manual_seed(LJ_SEED + b)
    vals_f = torch.rand((b, e_pad), device=dev, generator=gen)
    vals_i = torch.randint(0, LJ_N, (b, e_pad), device=dev, generator=gen,
                           dtype=torch.int32)
    ids = vals_i[0]                                  # shape only
    bound = bounds.bound_ms(bounds.segment_reduce(
        int(offs[-1]) - int(offs[0]), offs.numel(), n_pad, lanes=b))
    for what, vals, op in (("float32 add", vals_f, "add"),
                           ("int32 min", vals_i, "min")):
        if args.unchecked:
            med, lo, hi = kernel_ms(lambda: K.segment_reduce_sorted(
                vals, ids, offs, n_pad, op), args.calls, args.groups)
            record(what=f"lanes {what}: kernel, unchecked", b=b, ms=med,
                   ms_min=lo, ms_max=hi, bound_ms=bound)
            continue
        got = K.segment_reduce_sorted(vals, ids, offs, n_pad, op)
        rows_equal = all(torch.equal(got[r], K.segment_reduce_sorted(
            vals[r].contiguous(), ids, offs, n_pad, op)) for r in range(b))
        if op == "add":
            want = K.segment_reduce_sorted_ref(vals.double(), ids, offs,
                                               n_pad, op)
            close = bool(torch.allclose(got.double(), want, rtol=1e-5,
                                        atol=0.0))
            err = float((got.double() - want).abs().max())
        else:
            want = K.segment_reduce_sorted_ref(vals, ids, offs, n_pad, op)
            close = bool(torch.equal(got, want))
            err = float((got - want).abs().max())
        del want, got
        assert rows_equal and close, (what, rows_equal, close)
        record(what=f"lanes {what}: checks", b=b, ok=True,
               rows_equal_1d=rows_equal, max_abs_err=err)
        row = vals[0].contiguous()
        times = [
            ("kernel", lambda: K.segment_reduce_sorted(vals, ids, offs,
                                                       n_pad, op), 1),
            (f"{b} x the 1-D kernel", lambda: K.segment_reduce_sorted(
                row, ids, offs, n_pad, op), b)]
        if op == "add":
            col = vals.t().contiguous()              # [E_pad, B]
            offs64 = offs.long()
            times.append(("torch.segment_reduce on the [E_pad, B] transpose",
                          lambda: torch.segment_reduce(
                              col, "sum", offsets=offs64, axis=0), 1))
        for name, fn, mult in times:
            med, lo, hi = kernel_ms(fn, args.calls, args.groups)
            record(what=f"lanes {what}: {name}", b=b, ms=mult * med,
                   ms_min=mult * lo, ms_max=mult * hi, bound_ms=bound)
        med, lo, hi = kernel_ms(lambda: K.segment_reduce_sorted_ref(
            vals, ids, offs, n_pad, op), PLAIN_CALLS, PLAIN_GROUPS)
        record(what=f"lanes {what}: plain", b=b, ms=med, ms_min=lo,
               ms_max=hi, bound_ms=bound)
        if op == "add":
            del col
        del row
    del vals_f
    if not args.unchecked:
        lane_cumsum(args, K, record, vals_i)


def lane_cumsum(args, K, record, vals):
    """The lane-batched exclusive prefix sum on ``[B, E_pad]`` int32 values:
    each lane against the 1-D kernel on its row and the whole against the
    plain version (bit for bit), then timed beside B one-row launches, the
    plain version and ``torch.cumsum``."""
    from green_marl_tpu_torch.probes import bounds
    from green_marl_tpu_torch.utils.timing import kernel_ms
    b, e = vals.shape
    got = K.plain_cumsum(vals, exclusive=True)
    rows_equal = all(torch.equal(got[r], K.plain_cumsum(
        vals[r].contiguous(), exclusive=True)) for r in range(b))
    same = bool(torch.equal(got, K.plain_cumsum_ref(vals, exclusive=True)))
    del got
    assert rows_equal and same, ("lanes int32 exclusive cumsum", rows_equal,
                                 same)
    record(what="lanes int32 exclusive cumsum: checks", b=b, ok=True,
           rows_equal_1d=rows_equal, max_abs_err=0.0)
    bound = bounds.bound_ms(bounds.plain_cumsum(e, lanes=b, exclusive=True))
    row = vals[0].contiguous()
    for name, fn, mult, calls, groups in (
            ("kernel", lambda: K.plain_cumsum(vals, exclusive=True), 1,
             args.calls, args.groups),
            (f"{b} x the 1-D kernel", lambda: K.plain_cumsum(
                row, exclusive=True), b, args.calls, args.groups),
            ("torch.cumsum", lambda: torch.cumsum(vals, 1, dtype=torch.int32),
             1, args.calls, args.groups),
            ("plain", lambda: K.plain_cumsum_ref(vals, exclusive=True), 1,
             PLAIN_CALLS, PLAIN_GROUPS)):
        med, lo, hi = kernel_ms(fn, calls, groups)
        record(what=f"lanes int32 exclusive cumsum: {name}", b=b,
               ms=mult * med, ms_min=mult * lo, ms_max=mult * hi,
               bound_ms=bound)


def ptxas(root, source="segment_reduce.cu"):
    """``nvcc -Xptxas -v`` on ``csrc/<source>`` with the build's flags:
    ``(kernel, line)`` for each of its kernels' registers and spills as
    ptxas prints them."""
    from green_marl_tpu_torch.ops import _build
    src = os.path.join(root, "green_marl_tpu_torch", "csrc", source)
    out = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.devnull, src], capture_output=True, text=True, check=True)
    kernel, lines = None, []
    for line in (out.stdout + out.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("spill" in line or "Used" in line):
            lines.append((kernel, line.strip()))
    return lines


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--cache", default=os.path.join(
        "build", "green_marl_tpu_torch", f"rmat_lj_seed{LJ_SEED}_csc.npy"))
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--groups", type=int, default=7)
    ap.add_argument("--parts", action="store_true",
                    help="device time of each launch (torch.profiler)")
    ap.add_argument("--lanes", type=int, default=0, metavar="B",
                    help="time the lane-batched form at [B, E_pad]")
    ap.add_argument("--unchecked", action="store_true",
                    help="with --lanes: time the kernel alone, without "
                         "checks (for copies that leave out part of the "
                         "work)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v for the segment reduce")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probes/segment.py: needs an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    if args.ptxas:
        for kernel, line in ptxas(os.path.abspath(args.root)):
            print(json.dumps({"kernel": kernel, "ptxas": line}), flush=True)
        return
    from green_marl_tpu_torch.graph import native
    from green_marl_tpu_torch.ops import kernels as K
    from green_marl_tpu_torch.utils.timing import card as card_of

    dev = torch.device("cuda")
    card = card_of(dev)
    off_np = csc_offsets(native, args.cache)
    e_pad = -(-LJ_E // 128) * 128
    n_pad = -(-(LJ_N + 1) // 128) * 128
    deg = np.diff(off_np)
    offs = torch.from_numpy(off_np).to(dev)
    ids = torch.repeat_interleave(
        torch.arange(LJ_N, dtype=torch.int32, device=dev),
        torch.from_numpy(deg).to(dev), output_size=LJ_E)
    ids = torch.cat([ids, ids.new_full((e_pad - LJ_E,), LJ_N)])
    gen = torch.Generator(device=dev).manual_seed(LJ_SEED)
    vals_f = torch.rand(e_pad, device=dev, generator=gen)
    vals_i = torch.randint(0, LJ_N, (e_pad,), device=dev, generator=gen,
                           dtype=torch.int32)

    def record(**kw):
        print(json.dumps({"root": args.root, "card": card, **kw}),
              flush=True)

    record(what="shape", e_pad=e_pad, n_seg=LJ_N, n_out=n_pad,
           max_len=int(deg.max()), mean_len=float(deg.mean()),
           share_under_8=float((deg < 8).mean()),
           share_under_32=float((deg < 32).mean()),
           share_empty=float((deg == 0).mean()))
    if args.lanes:
        del ids, vals_f, vals_i
        return lanes(args, K, record, offs, n_pad, e_pad)

    # each kernel against its plain version
    got = K.segment_reduce_sorted(vals_f, ids, offs, n_pad, "add")
    want = K.segment_reduce_sorted_ref(vals_f.double(), ids, offs, n_pad,
                                       "add")
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=0.0)
    again = K.segment_reduce_sorted(vals_f, ids, offs, n_pad, "add")
    got_i = K.segment_reduce_sorted(vals_i, ids, offs, n_pad, "min")
    assert torch.equal(got_i, K.segment_reduce_sorted_ref(vals_i, ids, offs,
                                                          n_pad, "min"))
    scan = K.segmented_scan(vals_i, ids, "add")
    assert torch.equal(scan, K.segmented_scan_ref(vals_i, ids, "add"))
    tails = (offs[1:] - 1).clamp(min=0).long()
    nonempty = offs[1:] > offs[:-1]
    scan = K.segmented_scan(vals_f, ids, "add")
    assert torch.allclose(scan[tails][nonempty], got[:LJ_N][nonempty],
                          rtol=1e-5, atol=0.0)
    for excl in (False, True):
        assert torch.equal(K.plain_cumsum(vals_i, exclusive=excl),
                           K.plain_cumsum_ref(vals_i, exclusive=excl))
    record(what="checks", ok=True,
           float_add_same_bits_twice=bool(torch.equal(got, again)))
    del want, scan, tails, nonempty, got, again, got_i

    time_all(args, K, record, vals_f, vals_i, ids, offs, n_pad, e_pad)
    if args.parts:
        parts(K, record, "float32 add", vals_f, offs, n_pad)
    clipped_slab(args, K, record, vals_f, vals_i, offs, n_pad, e_pad)


if __name__ == "__main__":
    main()
