"""Plot frontends (paper §3.7): matplotlib images, standalone HTML with an
interactive-ish table, and plain CSV.  Batch-mode results are always rendered
separately from single-query results ("results obtained in batch mode are
always presented separately by the evaluation scripts").

A numpy-only copy of ``repro.core.plotting``, kept so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import html
import io
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.core.metrics import METRICS, RunRecord
from repro_torch.core.pareto import algorithm_frontiers, metric_points


def _split_by_mode(runs: Sequence[RunRecord]):
    return ([r for r in runs if not r.batch_mode],
            [r for r in runs if r.batch_mode])


def plot_png(
    runs: Sequence[RunRecord],
    path: str | Path,
    x_metric: str = "k-nn",
    y_metric: str = "qps",
    title: Optional[str] = None,
    scatter: bool = False,
    tuned: Optional[Sequence[tuple]] = None,
) -> Optional[Path]:
    """Pareto-frontier (or scatter) plot as a PNG via matplotlib.

    ``tuned`` marks auto-tuner operating points on the frontier: a
    sequence of ``(x, y, label)`` triples (e.g. the constrained argmax
    from the tuner), drawn as annotated stars.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xm, ym = METRICS[x_metric], METRICS[y_metric]
    fig, ax = plt.subplots(figsize=(7, 5))
    grouped = metric_points(runs, x_metric, y_metric)
    if not grouped:
        plt.close(fig)
        return None
    for algo in sorted(grouped):
        pts = grouped[algo]
        if scatter:
            ax.plot([p[0] for p in pts], [p[1] for p in pts], "o", ms=4,
                    label=algo, alpha=0.6)
        else:
            front = algorithm_frontiers(pts_to_runs(pts), x_metric, y_metric)[algo]
            if front:
                ax.plot([p[0] for p in front], [p[1] for p in front],
                        "-o", ms=4, label=algo)
    _mark_tuned(ax, tuned)
    if ym.name == "qps" or "size" in ym.name:
        ax.set_yscale("log")
    ax.set_xlabel(xm.description)
    ax.set_ylabel(ym.description)
    ax.set_title(title or f"{ym.description} vs {xm.description}")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def _mark_tuned(ax, tuned: Optional[Sequence[tuple]]) -> None:
    """Overlay (x, y, label) operating points as annotated stars."""
    for x, y, label in tuned or ():
        ax.plot([x], [y], marker="*", ms=16, color="crimson", zorder=5,
                linestyle="none",
                label=f"tuned: {label}" if label else "tuned")
        if label:
            ax.annotate(label, (x, y), textcoords="offset points",
                        xytext=(6, 6), fontsize=8)


def tune_plot_png(result, path: str | Path,
                  title: Optional[str] = None) -> Path:
    """Recall/QPS picture of one tuner result: every grid
    point, the Pareto frontier through them, and the chosen operating
    point starred."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    pts = result.points
    ax.plot([p.recall for p in pts], [p.qps for p in pts], "o", ms=4,
            color="#888", alpha=0.6, linestyle="none", label="grid")
    front = sorted(result.pareto, key=lambda p: p.recall)
    if front:
        ax.plot([p.recall for p in front], [p.qps for p in front], "-o",
                ms=5, label="pareto")
    if result.best is not None:
        label = ",".join(f"{k}={v}" for k, v in result.best.params.items())
        _mark_tuned(ax, [(result.best.recall, result.best.qps, label)])
    ax.set_yscale("log")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Queries per second (1/s)")
    default = "auto-tuned operating points"
    if result.constraint is not None:
        default += f" ({result.constraint})"
    ax.set_title(title or default)
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def pts_to_runs(pts) -> List[RunRecord]:
    return [p[2] for p in pts]


def to_csv(
    runs: Sequence[RunRecord],
    metric_names: Optional[Sequence[str]] = None,
) -> str:
    """All runs x all registered metrics as CSV (the website's data table)."""
    names = list(metric_names or METRICS.keys())
    buf = io.StringIO()
    buf.write("dataset,algorithm,instance,query_args,mode," + ",".join(names) + "\n")
    for r in runs:
        vals = []
        for n in names:
            try:
                vals.append(f"{METRICS[n].function(r):.6g}")
            except Exception:
                vals.append("nan")
        qa = ";".join(str(a) for a in r.query_arguments)
        mode = "batch" if r.batch_mode else "single"
        buf.write(f"{r.dataset},{r.algorithm},{r.instance_name},{qa},{mode},"
                  + ",".join(vals) + "\n")
    return buf.getvalue()


def export_website(
    runs: Sequence[RunRecord],
    out_dir: str | Path,
    x_metric: str = "k-nn",
    y_metric: str = "qps",
) -> Path:
    """Generate a small static site: one page per dataset with the frontier
    plot and the full data table (the paper's interactive-plot frontend)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    datasets = sorted({r.dataset for r in runs})
    index_items = []
    for ds in datasets:
        ds_runs = [r for r in runs if r.dataset == ds]
        for mode_name, mode_runs in zip(("single", "batch"),
                                        _split_by_mode(ds_runs)):
            if not mode_runs:
                continue
            stem = f"{ds}_{mode_name}"
            plot_png(mode_runs, out / f"{stem}.png", x_metric, y_metric,
                     title=f"{ds} [{mode_name}]")
            rows = []
            for r in mode_runs:
                rec = METRICS[x_metric].function(r)
                q = METRICS[y_metric].function(r)
                rows.append(
                    f"<tr><td>{html.escape(r.algorithm)}</td>"
                    f"<td>{html.escape(r.instance_name)}</td>"
                    f"<td>{html.escape(';'.join(map(str, r.query_arguments)))}</td>"
                    f"<td>{rec:.4f}</td><td>{q:.1f}</td>"
                    f"<td>{r.build_time:.2f}</td><td>{r.index_size_kb:.0f}</td></tr>"
                )
            page = (
                "<html><head><title>ANN-Benchmarks: "
                f"{html.escape(stem)}</title></head><body>"
                f"<h1>{html.escape(stem)}</h1>"
                f"<img src='{stem}.png' width='720'/>"
                "<table border=1 cellpadding=4><tr><th>algorithm</th>"
                "<th>instance</th><th>query args</th>"
                f"<th>{METRICS[x_metric].description}</th>"
                f"<th>{METRICS[y_metric].description}</th>"
                "<th>build (s)</th><th>index (kB)</th></tr>"
                + "".join(rows) + "</table></body></html>"
            )
            (out / f"{stem}.html").write_text(page)
            index_items.append(f"<li><a href='{stem}.html'>{stem}</a></li>")
    (out / "index.html").write_text(
        "<html><body><h1>ANN-Benchmarks results</h1><ul>"
        + "".join(index_items) + "</ul></body></html>")
    return out / "index.html"


def ascii_frontier(
    runs: Sequence[RunRecord],
    x_metric: str = "k-nn",
    y_metric: str = "qps",
    width: int = 68,
) -> str:
    """Terminal-friendly frontier summary (one line per frontier point)."""
    fronts = algorithm_frontiers(runs, x_metric, y_metric)
    lines = [f"{'algorithm':<24}{METRICS[x_metric].description:>12}"
             f"{METRICS[y_metric].description:>24}"]
    for algo in sorted(fronts):
        for x, y in fronts[algo]:
            lines.append(f"{algo:<24}{x:>12.4f}{y:>24.1f}")
    return "\n".join(lines)
