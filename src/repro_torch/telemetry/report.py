"""Text dashboard over an exported metrics registry.

    python -m repro_torch.telemetry.report telemetry_metrics.json [--top 8]

Renders the JSON that ``MetricsRegistry.write`` (or
``Telemetry.write_metrics``) produced: session counters, the per-pass
compile-time breakdown, top-N hot ports/switches, and a queue-buildup
sparkline over the sampled fabric timeline. Read-only — it consumes the
artifact, never the live session.
"""
from __future__ import annotations

import argparse
import sys

_BARS = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float], width: int = 60) -> str:
    """Unicode sparkline, downsampled to ``width`` by bucket-max (peaks
    must survive downsampling — they are the point of the plot)."""
    if not values:
        return ""
    if len(values) > width:
        per = len(values) / width
        values = [
            max(values[int(i * per): max(int((i + 1) * per), int(i * per) + 1)])
            for i in range(width)
        ]
    top = max(values)
    if top <= 0:
        return _BARS[0] * len(values)
    return "".join(_BARS[min(int(v / top * (len(_BARS) - 1) + 0.5), len(_BARS) - 1)]
                   for v in values)


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{us:.0f}us"


def render(data: dict, *, top: int = 8) -> str:
    lines: list[str] = []
    counters = data.get("counters", {})
    gauges = data.get("gauges", {})
    if counters:
        lines.append("== counters ==")
        for k, v in counters.items():
            lines.append(f"  {k:<32} {v:g}")
    if gauges:
        lines.append("== gauges ==")
        for k, v in gauges.items():
            lines.append(f"  {k:<32} {v:g}")

    # per-pass compile-time breakdown (histograms named pass.<name>.wall_us)
    hists = data.get("histograms", {})
    passes = {
        k[len("pass."):-len(".wall_us")]: h
        for k, h in hists.items()
        if k.startswith("pass.") and k.endswith(".wall_us")
    }
    if passes:
        grand = sum(h["total"] for h in passes.values()) or 1.0
        lines.append("== per-pass compile time ==")
        width = max(len(n) for n in passes)
        for name, h in sorted(passes.items(), key=lambda kv: -kv[1]["total"]):
            share = h["total"] / grand
            bar = "#" * max(1, int(share * 40))
            lines.append(
                f"  {name:<{width}}  {_fmt_us(h['total']):>8} "
                f"({share * 100:4.1f}%)  x{h['count']}  "
                f"mean {_fmt_us(h['mean'])}  {bar}"
            )
    other = {k: h for k, h in hists.items() if k not in
             {f"pass.{n}.wall_us" for n in passes}}
    if other:
        lines.append("== histograms ==")
        for k, h in other.items():
            lines.append(
                f"  {k:<32} n={h['count']} mean={h['mean']:.4g} "
                f"p50={h['p50']:.4g} p95={h['p95']:.4g} max={h['max']:.4g}"
            )

    for tname, title in (
        ("fabric.port_packets", f"top-{top} hot ports (packets forwarded)"),
        ("fabric.switch_queued", f"top-{top} queued switches (packets)"),
    ):
        table = data.get("tables", {}).get(tname)
        if table:
            ranked = sorted(table.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
            peak = ranked[0][1] or 1.0
            lines.append(f"== {title} ==")
            width = max(len(k) for k, _ in ranked)
            for key, v in ranked:
                bar = "#" * max(1, int(v / peak * 40))
                lines.append(f"  {key:<{width}}  {v:>12g}  {bar}")

    # anomaly / SLO panel (Telemetry.record_anomalies / record_slo)
    by_kind = data.get("tables", {}).get("anomaly.by_kind")
    if by_kind:
        total = counters.get("anomaly.events", sum(by_kind.values()))
        lines.append(f"== anomalies ({total:g} events) ==")
        width = max(len(k) for k in by_kind)
        for kind, n in sorted(by_kind.items(), key=lambda kv: (-kv[1], kv[0])):
            lines.append(f"  {kind:<{width}}  x{n:g}")
        lat = hists.get("anomaly.detection_latency_ticks")
        if lat:
            lines.append(
                f"  detection latency: mean {lat['mean']:.4g} ticks, "
                f"p95 {lat['p95']:.4g}, max {lat['max']:.4g}"
            )
        blamed = data.get("tables", {}).get("anomaly.by_switch")
        if blamed:
            ranked = sorted(blamed.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
            lines.append(
                "  implicated switches: "
                + ", ".join(f"{sw} (x{n:g})" for sw, n in ranked)
            )
    slo_margins = {
        k[len("slo."):-len(".margin_ticks")]: v
        for k, v in gauges.items()
        if k.startswith("slo.") and k.endswith(".margin_ticks")
    }
    if slo_margins:
        viol = counters.get("slo.violations", 0)
        lines.append(f"== SLO margins ({viol:g} violations) ==")
        width = max(len(j) for j in slo_margins)
        for job, margin in sorted(slo_margins.items(), key=lambda kv: kv[1]):
            flag = "MISS" if margin < 0 else "ok"
            lines.append(f"  {job:<{width}}  {margin:>+10g} ticks  {flag}")
        hot = data.get("tables", {}).get("slo.hot_switches")
        if hot:
            ranked = sorted(hot.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
            lines.append(
                "  blamed hot switches: "
                + ", ".join(f"{sw} (x{n:g})" for sw, n in ranked)
            )

    depth = data.get("series", {}).get("fabric.queue_depth")
    if depth:
        vals = [v for _, v in depth]
        lines.append("== fabric queue buildup (packets vs ticks) ==")
        lines.append(f"  {sparkline(vals)}")
        lines.append(
            f"  peak {max(vals):g} pkts @ tick "
            f"{depth[max(range(len(vals)), key=vals.__getitem__)][0]:g}; "
            f"{len(vals)} samples over {depth[-1][0]:g} ticks"
        )
    if not lines:
        lines.append("(registry is empty — run a Session with telemetry=True)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Render an exported telemetry metrics JSON as text.",
    )
    ap.add_argument("metrics", help="path to a MetricsRegistry JSON export")
    ap.add_argument("--top", type=int, default=8, metavar="N",
                    help="rows in the hot-port/switch tables (default 8)")
    args = ap.parse_args(argv)
    from repro_torch.telemetry.metrics import MetricsRegistry

    print(render(MetricsRegistry.load(args.metrics), top=args.top))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI
    sys.exit(main())
