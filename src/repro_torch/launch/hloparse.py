"""Mini HLO analyzer: loop-aware FLOPs / bytes / collective traffic; the
port's copy of ``repro.launch.hloparse`` (it imports only ``re`` and
``dataclasses``, and the port imports nothing of ``repro``).

The port compiles no HLO of its own: this copy reads an HLO text that
XLA gave the reference (``compiled.as_text()``), so the port's tools can
hold their own counts against it, and its ring model (``COLLECTIVES``,
:func:`_group_size` and the per-op formulas below) is the one
:mod:`repro_torch.launch.dryrun` prices its modelled collectives with.

Why not ``compiled.cost_analysis()`` alone?  XLA's HloCostAnalysis visits
every ``while`` body ONCE — a layer scan (or grad-accumulation scan)
under-counts by the trip count (verified empirically: scan(8 layers)
reports 1/8 the FLOPs of the unrolled version), so a loop-aware count
is needed.

The post-optimization HLO text is parsed into its computation graph and
evaluated bottom-up:

  flops(comp)   = sum dots/convs in comp + sum callees (while bodies
                  multiplied by XLA's known_trip_count annotation)
  bytes(comp)   = sum over FUSION-BOUNDARY ops of operand+result buffer
                  sizes (fusion bodies don't touch HBM; boundaries do)
  traffic(comp) = per-device ring-model bytes of every collective

Ring-traffic model per device (R the result's bytes):
  all-gather R*(g-1)/g; all-reduce 2*R*(g-1)/g; reduce-scatter R*(g-1);
  all-to-all R*(g-1)/g; collective-permute R.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "token": 0,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _shapes_in(txt: str):
    out = []
    for dt, dims in _SHAPE_RE.findall(txt):
        if dt not in DTYPE_BYTES:
            continue
        shape = [int(d) for d in dims.split(",")] if dims else []
        out.append((dt, shape))
    return out


def _bytes_of(txt: str) -> int:
    return sum(DTYPE_BYTES[dt] * _prod(s) for dt, s in _shapes_in(txt))


def _prod(xs):
    n = 1
    for x in xs:
        n *= x
    return n


@dataclass
class CompStats:
    flops: float = 0.0
    bytes: float = 0.0
    dot_bytes: float = 0.0
    traffic: float = 0.0
    traffic_f32: float = 0.0   # share of collective traffic in f32 (XLA's
                               # CPU lowering promotes bf16 to f32)
    coll_by_op: dict = field(default_factory=dict)
    calls: list = field(default_factory=list)   # (callee, multiplier, kind)


# one instruction line:  %name = <type|(tuple)> opcode(operands), attrs...
_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*"
    r"(\((?:[^()]|\([^()]*\))*\)|\S+)\s+"
    r"([a-z][a-z0-9\-]*)\((.*)$")
_TRIP = re.compile(r'known_trip_count[^0-9]+(\d+)')
_BODY = re.compile(r'body=%?([\w\.\-]+)')
_COND = re.compile(r'condition=%?([\w\.\-]+)')
_CALLS = re.compile(r'(?:calls|to_apply)=%?([\w\.\-]+)')
_BRANCHES = re.compile(r'branch_computations=\{([^}]*)\}')
_GROUPS = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_IOTA = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_CONTRACT = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")


_HDR_NAME = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s+\(")


def _split_computations(text: str) -> dict[str, list[str]]:
    """Computation headers sit at column 0 (instructions are indented);
    args may contain nested tuple parens, so only the name is parsed."""
    comps: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        if line[:1] not in ("", " ", "}", "\t") and "->" in line \
                and line.rstrip().endswith("{"):
            m = _HDR_NAME.match(line)
            if m:
                cur = m.group(1)
                comps[cur] = []
                continue
        if cur is not None:
            comps[cur].append(line)
    return comps


def _dot_flops(result_txt: str, lhs_txt: str, attrs: str) -> float:
    """2 * prod(result dims) * prod(lhs contracting dims)."""
    res_shapes = _shapes_in(result_txt)
    if not res_shapes:
        return 0.0
    result_elems = _prod(res_shapes[0][1])
    lhs_shapes = _shapes_in(lhs_txt)
    mc = _CONTRACT.search(attrs)
    if not lhs_shapes:
        return 0.0
    lhs = lhs_shapes[0][1]
    if mc:
        cdims = [int(x) for x in mc.group(1).split(",") if x != ""]
        contracted = _prod([lhs[i] for i in cdims if i < len(lhs)]) \
            if cdims else 1
    else:
        contracted = lhs[-1] if lhs else 1
    return 2.0 * result_elems * contracted


def _group_size(line: str) -> int:
    m = _IOTA.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS.search(line)
    if m:
        return len(m.group(1).split(","))
    return 1


def ring_traffic(op: str, r_bytes, g: int):
    """Per-device bytes of one collective ``op`` over a group of ``g``
    under the ring model, ``r_bytes`` its result's bytes a device."""
    if op == "all-gather":
        return r_bytes * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * r_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return r_bytes * (g - 1)
    if op == "all-to-all":
        return r_bytes * (g - 1) / g
    return float(r_bytes)


_BOUNDARY_OPS = {
    "fusion", "dot", "convolution", "copy", "all-gather", "all-reduce",
    "reduce-scatter", "all-to-all", "collective-permute", "scatter",
    "gather", "dynamic-slice", "dynamic-update-slice", "reduce", "sort",
    "transpose", "reshape", "broadcast", "concatenate", "slice", "iota",
    "convert", "pad", "select-and-scatter", "cholesky", "triangular-solve",
    "rng", "rng-bit-generator", "exponential", "tanh", "add", "multiply",
}
_NO_BYTES = {"parameter", "constant", "tuple", "get-tuple-element",
             "bitcast", "while", "call", "conditional", "custom-call",
             "after-all", "partition-id", "replica-id", "domain",
             "opt-barrier"}


def _analyze_comp(lines: list[str]) -> CompStats:
    st = CompStats()
    # pass 1: symbol table  name -> result-type text (operands are %refs)
    types: dict[str, str] = {}
    parsed = []
    for line in lines:
        m = _INSTR.match(line)
        if not m:
            continue
        name, rtype, op, rest = m.groups()
        types[name] = rtype
        parsed.append((name, rtype, op, rest, line))

    def operand_types(rest: str) -> list[str]:
        ops_str = rest.split(")", 1)[0]
        return [types.get(r, "") for r in
                re.findall(r"%([\w\.\-]+)", ops_str)]

    for name, rtype, op, rest, line in parsed:
        if op.endswith("-done"):
            continue
        base = op[:-6] if op.endswith("-start") else op
        if base in COLLECTIVES:
            rbytes = _bytes_of(rtype)
            g = _group_size(line)
            if g > 1:
                t = ring_traffic(base, rbytes, g)
                st.traffic += t
                if "f32[" in rtype and "bf16[" not in rtype:
                    st.traffic_f32 += t
                d = st.coll_by_op.setdefault(base,
                                             {"count": 0, "traffic": 0.0})
                d["count"] += 1
                d["traffic"] += t
        if base == "dot":
            otypes = operand_types(rest)
            st.flops += _dot_flops(rtype, otypes[0] if otypes else "", rest)
            st.dot_bytes += _bytes_of(rtype) + sum(_bytes_of(t)
                                                   for t in otypes)
        if base == "while":
            body = _BODY.search(line)
            cond = _COND.search(line)
            trips = _TRIP.search(line)
            n = int(trips.group(1)) if trips else 1
            if body:
                st.calls.append((body.group(1), n, "while"))
            if cond:
                st.calls.append((cond.group(1), n, "while"))
        elif base in ("fusion", "call", "custom-call", "async-start"):
            for callee in _CALLS.findall(line):
                st.calls.append((callee, 1,
                                 "fusion" if base == "fusion" else "call"))
        elif base in ("reduce", "reduce-window", "scatter", "sort",
                      "select-and-scatter", "reduce-scatter", "all-reduce",
                      "map"):
            # reduction regions (to_apply) are tiny but keep the graph whole
            for callee in _CALLS.findall(line):
                st.calls.append((callee, 1, "call"))
        elif base == "conditional":
            mb = _BRANCHES.search(line)
            if mb:
                for b in mb.group(1).split(","):
                    st.calls.append((b.strip().lstrip("%"), 1,
                                     "conditional"))
        # fusion-boundary bytes: result + operand buffers of top-level ops
        if base not in _NO_BYTES:
            st.bytes += _bytes_of(rtype)
            for ot in operand_types(rest):
                st.bytes += _bytes_of(ot)
    return st


def analyze(hlo_text: str) -> dict:
    comps = {name: _analyze_comp(lines)
             for name, lines in _split_computations(hlo_text).items()}
    memo: dict[str, tuple] = {}
    fused = set()
    for st in comps.values():
        for callee, _, kind in st.calls:
            if kind == "fusion":
                fused.add(callee)

    def total(name: str, depth=0):
        if name in memo:
            return memo[name]
        st = comps.get(name)
        if st is None or depth > 64:
            return (0.0, 0.0, 0.0, 0.0, 0.0, {})
        memo[name] = (0.0, 0.0, 0.0, 0.0, 0.0, {})     # cycle guard
        f, b, db, t = st.flops, st.bytes, st.dot_bytes, st.traffic
        t32 = st.traffic_f32
        coll = {k: dict(v) for k, v in st.coll_by_op.items()}
        for callee, mult, kind in st.calls:
            if kind == "fusion":
                # only dot flops/bytes inside fusions count; boundary bytes
                # are already accounted at the fusion op itself
                cf, _, cdb, ct, ct32, ccoll = total(callee, depth + 1)
                f += cf * mult
                db += cdb * mult
                t += ct * mult
                t32 += ct32 * mult
            else:
                cf, cb, cdb, ct, ct32, ccoll = total(callee, depth + 1)
                f += cf * mult
                b += cb * mult
                db += cdb * mult
                t += ct * mult
                t32 += ct32 * mult
            for k, v in ccoll.items():
                d = coll.setdefault(k, {"count": 0, "traffic": 0.0})
                d["count"] += v["count"] * mult
                d["traffic"] += v["traffic"] * mult
        memo[name] = (f, b, db, t, t32, coll)
        return memo[name]

    entry = None
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            m = re.match(r"ENTRY\s+%?([\w\.\-]+)", line)
            if m:
                entry = m.group(1)
            break
    if entry is None:
        # fall back: pick the computation with the most flops
        entry = max(comps, key=lambda n: comps[n].flops, default=None)
    f, b, db, t, t32, coll = total(entry) if entry \
        else (0.0, 0.0, 0.0, 0.0, 0.0, {})
    return {"flops_per_device": f,
            "bytes_boundary_per_device": b,    # CPU-fusion upper bound
            "bytes_dot_per_device": db,        # operand + result bytes of dots
            "collective_traffic_per_device": t,
            "collective_traffic_f32_per_device": t32,
            "collectives": coll,
            "entry": entry, "n_computations": len(comps)}
