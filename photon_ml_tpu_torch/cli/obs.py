"""photon-obs: read the telemetry files a run writes.

Port of `photon_ml_tpu/cli/obs.py`, with the same subcommands, output text
and exit codes, reading through the port's `utils/telemetry.py`:

  * `trace <trace.json>`: a Chrome trace-event export's span count, thread
    tracks and wall coverage; `--min-coverage P` exits 1 when the union of
    the spans covers less than P% of the traced wall.
  * `journal <journal.jsonl>`: event counts by type; `--validate` exits 1
    when a line fails its `contracts.JOURNAL_EVENT_SCHEMAS` schema.
  * `profile <profile.json>`: a run profile read through the loud
    `telemetry.read_profile` contract (stages, dispatch decisions, bucket
    shapes, topology, roofline, nonzero counters).
  * `profile diff <a> <b>`: stage deltas, dispatch-decision, plan-block and
    topology changes between two profiles; exits 1 when either breaks its
    contract or the kinds differ.
  * `decisions <journal.jsonl>`: the control-plane timeline (plan,
    autopilot, shadow and tier decisions, the autopilot's rollbacks and
    quarantines under them); exits 1 when a line fails its schema.

Load a trace itself in Perfetto (https://ui.perfetto.dev) or
chrome://tracing; this CLI is the headless companion. It runs on the CPU
and reads files either package wrote.

Usage: python -m photon_ml_tpu_torch.cli.obs --help
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

from photon_ml_tpu_torch.utils import telemetry


def _interval_union_us(spans: List[Tuple[float, float]]) -> float:
    """Microseconds covered by the union of [start, end) intervals."""
    total = 0.0
    end = None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def cmd_trace(args) -> int:
    with open(args.path) as f:
        doc = json.load(f)
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    threads = {e["tid"]: e["args"]["name"] for e in doc.get("traceEvents", [])
               if e.get("ph") == "M" and e.get("name") == "thread_name"}
    if not events:
        print("no spans recorded (was PHOTON_TRACE=1 set?)")
        return 1
    intervals = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events]
    wall_us = max(max(e for _, e in intervals) - min(s for s, _ in intervals), 1e-9)
    coverage = 100.0 * _interval_union_us(intervals) / wall_us
    by_thread: dict = {}
    for e in events:
        by_thread.setdefault(e["tid"], []).append(e)
    print(f"trace: {len(events)} span(s), {len(by_thread)} thread track(s), "
          f"{wall_us / 1e6:.3f}s traced wall")
    print(f"span coverage of traced wall: {coverage:.1f}%")
    for tid, evs in sorted(by_thread.items(), key=lambda kv: -len(kv[1])):
        top = max(evs, key=lambda e: e.get("dur", 0.0))
        print(f"  {threads.get(tid, str(tid)):32s} {len(evs):6d} span(s)  "
              f"longest: {top['name']} ({top.get('dur', 0.0) / 1e3:.1f} ms)")
    span_ids = {e["args"].get("span_id") for e in events}
    orphans = [e for e in events
               if e["args"].get("parent_id") is not None and e["args"]["parent_id"] not in span_ids]
    if orphans:
        print(f"WARNING: {len(orphans)} span(s) reference a missing parent")
    if args.min_coverage is not None and coverage < args.min_coverage:
        print(f"FAIL: coverage {coverage:.1f}% < required {args.min_coverage}%")
        return 1
    return 0


def cmd_journal(args) -> int:
    n_ok, errors = telemetry.validate_journal(args.path)
    counts: dict = {}
    with open(args.path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            try:
                etype = json.loads(raw).get("type")
            except ValueError:
                etype = "<unparseable>"
            counts[etype] = counts.get(etype, 0) + 1
    print(f"journal: {sum(counts.values())} line(s), {n_ok} valid, {len(errors)} invalid")
    for etype in sorted(counts, key=counts.get, reverse=True):
        print(f"  {etype:24s} {counts[etype]}")
    for err in errors[:20]:
        print(f"  INVALID: {err}")
    return 1 if args.validate and errors else 0


# Event types rendered as timeline rows; the autopilot's rollback and
# quarantine events ride along as indented annotations. The precision
# ladder's (`tier_demote`, `tier_restore`) come from the port's registry
# (serving/tenancy.py) and the reference's alike.
_DECISION_TYPES = ("plan_decision", "autopilot_decision", "shadow_verdict", "tier_demote",
                   "tier_restore")
_ANNOTATION_TYPES = ("autopilot_rollback", "rule_quarantined")


def _fmt_evidence(ev) -> str:
    if not ev:
        return ""
    if isinstance(ev, dict):
        parts = []
        for k in sorted(ev):
            v = ev[k]
            parts.append(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={json.dumps(v, default=str)}")
        return " ".join(parts)
    return json.dumps(ev, default=str)


def _decision_line(doc: dict) -> str:
    etype = doc["type"]
    if etype == "plan_decision":
        return (f"plan      {doc.get('decision')} = {json.dumps(doc.get('value'), default=str)} "
                f"[{doc.get('source')}] (fallback {json.dumps(doc.get('fallback'), default=str)})")
    if etype == "autopilot_decision":
        action = doc.get("action") or {}
        what = (f"{action.get('kind')}" + (f" tenant={action.get('tenant')}" if action.get("tenant") else "")
                if isinstance(action, dict) else "(no action)")
        line = f"autopilot {doc.get('rule')}: {what} -> {doc.get('outcome')}"
        ev = _fmt_evidence(doc.get("evidence"))
        return line + (f"  | {ev}" if ev else "")
    if etype == "shadow_verdict":
        return (f"shadow    {doc.get('challenger')} vs {doc.get('champion')}: {doc.get('decision')} "
                f"after {doc.get('windows')} window(s) ({doc.get('evaluator')}: "
                f"{doc.get('challenger_metric')} vs {doc.get('champion_metric')}) — {doc.get('reason')}")
    if etype in ("tier_demote", "tier_restore"):
        arrow = "v" if etype == "tier_demote" else "^"
        bytes_key = "freed_bytes" if etype == "tier_demote" else "repinned_bytes"
        line = (f"tier {arrow}    tenant={doc.get('tenant')} {doc.get('from_tier')} -> "
                f"{doc.get('to_tier')} [{doc.get('reason')}] ({bytes_key}={doc.get(bytes_key)})")
        ev = _fmt_evidence(doc.get("evidence"))
        return line + (f"  | {ev}" if ev else "")
    if etype == "autopilot_rollback":
        action = doc.get("action") or {}
        kind = action.get("kind") if isinstance(action, dict) else action
        return f"  ROLLBACK  {doc.get('rule')} ({kind}): {doc.get('reason')}"
    return (f"  QUARANTINE {doc.get('rule')} after {doc.get('rollbacks')} rollback(s): "
            f"{doc.get('reason')}")


def cmd_decisions(args) -> int:
    """The control-plane timeline: plan, autopilot, shadow and tier
    decisions with the autopilot's rollbacks and quarantines, each at its
    offset from the first; exits 1 when a journal line fails its schema."""
    n_ok, errors = telemetry.validate_journal(args.path)
    rows: List[dict] = []
    with open(args.path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            try:
                doc = json.loads(raw)
            except ValueError:
                continue  # already reported by validate_journal
            if doc.get("type") in _DECISION_TYPES + _ANNOTATION_TYPES:
                rows.append(doc)
    counts: dict = {}
    for doc in rows:
        counts[doc["type"]] = counts.get(doc["type"], 0) + 1
    print(f"decisions: {len(rows)} control-plane event(s) "
          f"({', '.join(f'{counts[t]} {t}' for t in sorted(counts)) or 'none'})")
    t0 = rows[0].get("ts", 0.0) if rows else 0.0
    for doc in rows:
        try:
            dt = float(doc.get("ts", t0)) - float(t0)
        except (TypeError, ValueError):
            dt = 0.0
        print(f"  +{dt:9.3f}s  {_decision_line(doc)}")
    if errors:
        print(f"{len(errors)} schema-invalid journal line(s):")
        for err in errors[:20]:
            print(f"  INVALID: {err}")
        return 1
    return 0


def cmd_profile(args) -> int:
    profile = telemetry.read_profile(args.path)  # a profile without a key of its kind raises
    topo = profile["device_topology"]
    print(f"{profile['kind']} profile: {profile['wall_s']}s wall on {topo['device_count']}x "
          f"{topo['platform']} ({topo.get('device_kind', '?')})")
    roof = profile["roofline"].get("hbm_gb_per_s")
    if roof:
        print(f"  HBM roofline: {roof} GB/s")
    print("  stages:")
    stages = profile["stages"]
    width = max((len(k) for k in stages), default=0)
    for k in sorted(stages, key=lambda k: -float(stages[k] or 0)):
        print(f"    {k.ljust(width)}  {float(stages[k]):10.3f}s")
    print("  dispatch decisions:")
    for k, v in sorted(profile["dispatch"].items()):
        print(f"    {k}: {json.dumps(v, default=str)}")
    shapes = profile["bucket_shapes"]
    if shapes:
        print("  bucket shapes:")
        for k, v in sorted(shapes.items()):
            print(f"    {k}: {json.dumps(v)[:120]}")
    counters = (profile.get("metrics") or {}).get("counters") or {}
    nonzero = {k: v for k, v in counters.items() if v}
    print(f"  nonzero counters: {json.dumps(nonzero) if nonzero else '(none)'}")
    return 0


def _plan_decisions(profile: dict) -> dict:
    """decision -> (value, source) from a profile's plan block (the JAX
    package's planned runs write one); empty without one."""
    block = profile.get("plan") or {}
    return {d["decision"]: (d.get("value"), d.get("source")) for d in block.get("decisions", [])
            if isinstance(d, dict) and "decision" in d}


def cmd_profile_diff(path_a: str, path_b: str) -> int:
    """Two profiles compared key by key; 1 when either breaks its contract
    or their kinds differ."""
    dumps = lambda v: json.dumps(v, default=str)
    try:
        a = telemetry.read_profile(path_a)
        b = telemetry.read_profile(path_b)
    except (ValueError, OSError) as exc:
        print(f"CONTRACT VIOLATION: {exc}")
        return 1
    if a.get("kind") != b.get("kind"):
        print(f"CONTRACT VIOLATION: profile kinds differ ({a.get('kind')!r} vs {b.get('kind')!r}) "
              "— comparing a fit profile to a serve profile is not a round-over-round diff")
        return 1
    print(f"{a['kind']} profiles: {path_a} ({a['wall_s']}s) vs {path_b} ({b['wall_s']}s)")

    topo_a, topo_b = a["device_topology"], b["device_topology"]
    topo_changed = {k: (topo_a.get(k), topo_b.get(k)) for k in sorted({*topo_a, *topo_b})
                    if topo_a.get(k) != topo_b.get(k)}
    if topo_changed:
        print("  topology changes:")
        for k, (va, vb) in topo_changed.items():
            print(f"    {k}: {va!r} -> {vb!r}")

    st_a, st_b = a["stages"], b["stages"]
    keys = sorted({*st_a, *st_b})
    width = max((len(k) for k in keys), default=0)
    print("  stage deltas (a -> b):")
    for k in keys:
        va, vb = float(st_a.get(k) or 0.0), float(st_b.get(k) or 0.0)
        mark = "" if abs(vb - va) < 1e-4 else f"  ({vb - va:+.3f}s)"
        print(f"    {k.ljust(width)}  {va:10.3f}s -> {vb:10.3f}s{mark}")

    d_a, d_b = a["dispatch"], b["dispatch"]
    changed = [k for k in sorted({*d_a, *d_b}) if d_a.get(k) != d_b.get(k)]
    if changed:
        print("  dispatch-decision changes:")
        for k in changed:
            print(f"    {k}: {dumps(d_a.get(k))} -> {dumps(d_b.get(k))}")
    else:
        print("  dispatch decisions: identical")

    plan_a, plan_b = _plan_decisions(a), _plan_decisions(b)
    added = sorted(set(plan_b) - set(plan_a))
    removed = sorted(set(plan_a) - set(plan_b))
    altered = sorted(k for k in set(plan_a) & set(plan_b) if plan_a[k] != plan_b[k])
    if not (plan_a or plan_b):
        print("  plan blocks: none on either side (unplanned runs)")
    elif not (added or removed or altered):
        print(f"  plan decisions: identical ({len(plan_b)})")
    else:
        print("  plan-block changes:")
        for k in added:
            print(f"    + {k} = {dumps(plan_b[k][0])} [{plan_b[k][1]}]")
        for k in removed:
            print(f"    - {k} (was {dumps(plan_a[k][0])} [{plan_a[k][1]}])")
        for k in altered:
            print(f"    ~ {k}: {dumps(plan_a[k][0])} [{plan_a[k][1]}] -> "
                  f"{dumps(plan_b[k][0])} [{plan_b[k][1]}]")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.cli.obs",
        description="Inspect photon-trace telemetry artifacts (trace.json / journal.jsonl / profile.json)")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("trace", help="summarize a Chrome trace export")
    t.add_argument("path")
    t.add_argument("--min-coverage", type=float, default=None,
                   help="exit 1 when span union covers less than this %% of the traced wall")
    j = sub.add_parser("journal", help="summarize/validate a run journal")
    j.add_argument("path")
    j.add_argument("--validate", action="store_true", help="exit 1 when any line fails its schema")
    d = sub.add_parser("decisions", help="control-plane timeline: plan / autopilot / shadow decisions")
    d.add_argument("path")
    pr = sub.add_parser("profile", help="pretty-print a run profile, or `profile diff <a> <b>`")
    pr.add_argument("paths", nargs="+", metavar="ARG", help="<profile.json>  |  diff <a.json> <b.json>")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "trace":
        return cmd_trace(args)
    if args.cmd == "journal":
        return cmd_journal(args)
    if args.cmd == "decisions":
        return cmd_decisions(args)
    if args.paths[0] == "diff":
        if len(args.paths) != 3:
            parser.error("profile diff takes exactly two profile paths")
        return cmd_profile_diff(args.paths[1], args.paths[2])
    if len(args.paths) != 1:
        parser.error("profile takes one path (or: profile diff <a> <b>)")
    args.path = args.paths[0]
    return cmd_profile(args)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
