"""Critical-path attribution over span trees.

Given one request's spans (``obs/spans.py``), :func:`decompose` bills
every instant of the request window to exactly one named stage —
edge queue, admission wait, prefill, KV wire, spill promotion, decode,
retry/backoff idle — so "p99 TTFT regressed" becomes "62% of p99 TTFT
is spill promotion". The algorithm is a deepest-covering interval
sweep: take every span boundary inside the window as a cut point, and
bill each segment between consecutive cuts to the DEEPEST span
covering its midpoint, walking up the ancestry to the nearest span
with a recognized stage (``unattributed`` when none covers it). By
construction the per-stage sums equal the window length EXACTLY — the
decomposition cannot silently lose time — which is what lets callers
assert stage-sum == measured wall time instead of trusting it.

:func:`aggregate` lifts per-request decompositions to fleet-wide
percentile attribution: pick the tail set at quantile ``q`` by the
chosen window (TTFT or total), and report each stage's share of the
tail's total time plus the dominant stage. The router's
``GET /debug/traces`` serves this over every replica's retained
traces.

Stage spans may overlap structural parents arbitrarily (that is the
point of the tree); overlapping SIBLING stage spans bill to whichever
is deeper-then-later, which for the serving planes' sequential stages
only occurs at clock-skew edges a few microseconds wide.

Copied into the port from ``elephas_tpu/obs/critical_path.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
from typing import Dict, Iterable, List, Optional

from .metrics import percentile

__all__ = ["STAGES", "aggregate", "build_tree", "decompose"]

#: recognized critical-path stages, in pipeline order. Spans with
#: other ``stage`` values still bill (the taxonomy is open), but these
#: are the ones the serving planes emit and the docs catalog.
STAGES = (
    "edge_queue",       # router-side: dispatch attempts, proxy wait
    "admission_wait",   # engine queue: submit -> slot admission
    "prefill",          # prefill forward (colocated or prefill tier)
    "kv_wire",          # disagg KV shipping over the wire
    "spill_promote",    # tiered-KV promotion host/storage -> device
    "spill_demote",     # tiered-KV demotion device -> host/storage
    "session_save",     # cross-request session KV save
    "session_restore",  # cross-request session KV restore
    "decode",           # first token -> retirement
    "retry_backoff",    # resilience idle: backoff sleeps, hedge waits
)


def build_tree(spans: Iterable) -> List[dict]:
    """Parent-link spans into forest form: ``[{"span", "children"}]``
    roots, children sorted by start. Orphans (parent id never seen —
    the remote half of a cross-process edge) become roots."""
    spans = list(spans)
    nodes = {s.span_id: {"span": s, "children": []} for s in spans}
    roots = []
    for s in spans:
        parent = nodes.get(s.parent_id) if s.parent_id else None
        if parent is not None and parent["span"] is not s:
            parent["children"].append(nodes[s.span_id])
        else:
            roots.append(nodes[s.span_id])
    for n in nodes.values():
        n["children"].sort(key=lambda c: c["span"].start)
    roots.sort(key=lambda c: c["span"].start)
    return roots


def _depths(spans: List) -> Dict[str, int]:
    by_id = {s.span_id: s for s in spans}
    depths: Dict[str, int] = {}

    def depth(sid: str, seen: set) -> int:
        if sid in depths:
            return depths[sid]
        if sid in seen:  # defensive: a parent cycle would loop forever
            depths[sid] = 0
            return 0
        seen.add(sid)
        pid = by_id[sid].parent_id
        d = depth(pid, seen) + 1 if pid and pid in by_id else 0
        depths[sid] = d
        return d

    for s in spans:
        depth(s.span_id, set())
    return depths


def _stage_of(span, by_id: Dict[str, object]) -> str:
    """The span's stage, or the nearest staged ancestor's."""
    seen = set()
    cur = span
    while cur is not None and cur.span_id not in seen:
        if cur.stage:
            return cur.stage
        seen.add(cur.span_id)
        cur = by_id.get(cur.parent_id) if cur.parent_id else None
    return "unattributed"


def _attribute(spans: List, w0: float, w1: float) -> Dict[str, float]:
    """Bill [w0, w1] to stages by deepest-covering sweep; the values
    sum to (w1 - w0) exactly."""
    out: Dict[str, float] = {}
    if w1 <= w0:
        return out
    by_id = {s.span_id: s for s in spans}
    depths = _depths(spans)
    cuts = {w0, w1}
    for s in spans:
        if s.end > w0 and s.start < w1:
            cuts.add(min(max(s.start, w0), w1))
            cuts.add(min(max(s.end, w0), w1))
    pts = sorted(cuts)
    for a, b in zip(pts, pts[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2.0
        covering = [s for s in spans if s.start <= mid < s.end]
        if covering:
            # deepest wins; among equals, the later-started (the
            # actual work, not the structural wrapper)
            best = max(covering,
                       key=lambda s: (depths.get(s.span_id, 0), s.start))
            stage = _stage_of(best, by_id)
        else:
            stage = "unattributed"
        out[stage] = out.get(stage, 0.0) + (b - a)
    return out


def _find_root(spans: List):
    ids = {s.span_id for s in spans}
    roots = [s for s in spans if not s.parent_id or s.parent_id not in ids]
    if not roots:
        return None
    named = [s for s in roots if s.name == "serving.request"]
    pool = named or roots
    return min(pool, key=lambda s: s.start)


def decompose(spans: Iterable, ttft_s: Optional[float] = None,
              total_s: Optional[float] = None,
              tolerance: float = 0.05) -> Optional[dict]:
    """Stage decomposition of one trace. The window origin is the
    tree root's start; the TTFT window is ``[origin, origin+ttft_s]``
    and the total window ``[origin, origin+total_s]`` (both default
    from the root span / its ``ttft_s`` attr when present). ``ok`` is
    the exactness check: |stage sum - window| / window <= tolerance
    per window (always true for the sweep; it guards the contract)."""
    spans = list(spans)
    if not spans:
        return None
    root = _find_root(spans)
    if root is None:
        return None
    origin = root.start
    if total_s is None:
        total_s = root.duration_s
    if ttft_s is None:
        t = root.attrs.get("ttft_s") if root.attrs else None
        ttft_s = float(t) if t is not None else None
    out = {
        "trace_id": root.trace_id,
        "root_span_id": root.span_id,
        "origin": origin,
        "total_s": total_s,
        "ttft_s": ttft_s,
        "n_spans": len(spans),
    }
    ok = True
    stages_total = _attribute(spans, origin, origin + max(total_s, 0.0))
    out["stages_total"] = stages_total
    if total_s and total_s > 0:
        ok &= abs(sum(stages_total.values()) - total_s) <= tolerance * total_s
    if ttft_s is not None:
        stages_ttft = _attribute(spans, origin, origin + max(ttft_s, 0.0))
        out["stages_ttft"] = stages_ttft
        if ttft_s > 0:
            ok &= abs(sum(stages_ttft.values()) - ttft_s) \
                <= tolerance * ttft_s
    out["ok"] = bool(ok)
    return out


def aggregate(decomps: Iterable[dict], q: float = 0.99,
              window: str = "ttft") -> dict:
    """Fleet-wide percentile attribution over per-trace
    decompositions: each stage's share of the quantile-``q`` tail's
    time for the chosen ``window`` ("ttft" or "total")."""
    key_v = "ttft_s" if window == "ttft" else "total_s"
    key_s = "stages_ttft" if window == "ttft" else "stages_total"
    usable = [d for d in decomps
              if d and d.get(key_v) is not None and d.get(key_s)]
    if not usable:
        return {"window": window, "quantile": q, "requests": 0,
                "tail_requests": 0, "attribution": {},
                "dominant_stage": None, "threshold_s": None}
    vals = [d[key_v] for d in usable]
    thr = percentile(vals, q)
    tail = [d for d in usable if d[key_v] >= thr] or usable
    shares: Dict[str, float] = {}
    denom = 0.0
    for d in tail:
        for stage, sec in d[key_s].items():
            shares[stage] = shares.get(stage, 0.0) + sec
            denom += sec
    attribution = {stage: (sec / denom if denom > 0 else 0.0)
                   for stage, sec in sorted(shares.items(),
                                            key=lambda kv: -kv[1])}
    dominant = next(iter(attribution), None)
    return {
        "window": window,
        "quantile": q,
        "requests": len(usable),
        "tail_requests": len(tail),
        "threshold_s": thr,
        "attribution": attribution,
        "attributed_seconds": denom,
        "dominant_stage": dominant,
    }
