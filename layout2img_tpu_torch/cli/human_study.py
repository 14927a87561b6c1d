"""Human-study preference charts (paper Fig. analog).

The port's own copy of ``layout2img_tpu/cli/human_study.py``: that module
imports no JAX, but the port imports nothing of the JAX package.

    python -m layout2img_tpu_torch.cli.human_study [--json study.json] [--out_dir charts]

Equivalent of the reference ``manual_result_visulization.py``:
offline visualization of two-alternative-forced-choice human-study results
(percentage of participants preferring our model over a baseline, per
participant P1..P10 and overall). The reference renders interactive
``plt.show()`` pies/bars of hardcoded constants; here the same defaults are
bundled as *data*, a ``--json`` flag accepts new study results, and charts are
written as PNGs (headless / Agg: a server has no display). matplotlib is
imported where a chart is drawn; where it is not installed the CLI exits
non-zero with one line that says so.

The reference bar chart also plots its 4th series at ``x + 3*width`` with
``n=3`` series' worth of width (``manual_result_visulization.py:31-38``),
overlapping the next group; the grouped-bar layout here is computed for the
actual series count.

JSON schema::

    [{"name": "Ours-D vs LostGAN",
      "labels": ["ours-D", "lostgan"],
      "results": {"coco": {"P1": 57, ..., "all": 54.3},
                  "vg":   {...}}}, ...]

Values are the percentage preferring the first label.
"""

from __future__ import annotations

import argparse
import json
import os

# fixed categorical order (validated palette; color follows the entity)
_SERIES_COLORS = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]
_PIE_OTHER = "#c3c2b7"  # neutral for the "baseline preferred" remainder
_INK = "#1a1a19"
_INK_MUTED = "#6b6a63"

# The paper's human-study numbers (reference manual_result_visulization.py:63-84):
# % of choices preferring ours, per participant, 'all' = overall mean.
DEFAULT_STUDIES = [
    {
        "name": "Ours-D vs LostGAN",
        "labels": ["ours-D", "lostgan"],
        "results": {
            "coco": {"P1": 57, "P2": 50, "P3": 49, "P4": 60, "P5": 57,
                     "P6": 58, "P7": 62, "P8": 48, "P9": 49, "P10": 48,
                     "all": 54.3},
            "vg": {"P1": 53, "P2": 53, "P3": 61, "P4": 45, "P5": 62,
                   "P6": 61, "P7": 63, "P8": 55, "P9": 53, "P10": 56,
                   "all": 56.7},
        },
    },
    {
        "name": "Ours-ED vs layout2im",
        "labels": ["ours-ED", "layout2im"],
        "results": {
            "coco": {"P1": 56, "P2": 48, "P3": 47, "P4": 52, "P5": 49,
                     "P6": 56, "P7": 48, "P8": 47, "P9": 52, "P10": 49,
                     "all": 52.3},
            "vg": {"P1": 53, "P2": 48, "P3": 49, "P4": 56, "P5": 54,
                   "P6": 55, "P7": 53, "P8": 55, "P9": 54, "P10": 51,
                   "all": 52.8},
        },
    },
]


def _plt():
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("cli.human_study draws its charts with matplotlib, which is not "
                         "installed here") from None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_pies(study: dict, out_path: str) -> None:
    """One pie per participant per dataset (reference show_results)."""
    plt = _plt()
    datasets = list(study["results"].items())
    rows = len(datasets)
    cols = max(len(v) for _, v in datasets)
    fig, axes = plt.subplots(rows, cols, figsize=(1.9 * cols, 2.2 * rows),
                             squeeze=False)
    fig.suptitle(study["name"], fontsize=13, fontweight="bold", color=_INK)
    ours, baseline = study["labels"]
    for r, (dataset, values) in enumerate(datasets):
        for c in range(cols):
            ax = axes[r][c]
            if c >= len(values):
                ax.axis("off")
                continue
            name, pct = list(values.items())[c]
            ax.pie([pct, 100.0 - pct], startangle=90,
                   colors=[_SERIES_COLORS[0], _PIE_OTHER],
                   wedgeprops={"linewidth": 2, "edgecolor": "white"})
            ax.set_title(f"{dataset} {name}\n{pct:.1f}% {ours}",
                         fontsize=8, color=_INK)
    fig.legend([ours, baseline], loc="lower center", ncol=2, frameon=False,
               fontsize=9)
    fig.tight_layout(rect=(0, 0.04, 1, 0.95))
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def render_bars(studies: list[dict], out_path: str) -> None:
    """Grouped bars: one group per participant, one bar per study x dataset
    (reference show_results_inbar, with correct group geometry)."""
    plt = _plt()
    import numpy as np

    series = []  # (label, values aligned on participant keys)
    keys = list(next(iter(studies[0]["results"].values())).keys())
    for study in studies:
        for dataset, values in study["results"].items():
            series.append((f"{study['labels'][0]} on {dataset.upper()}",
                           [float(values.get(k, 0.0)) for k in keys]))
    n = len(series)
    x = np.arange(len(keys), dtype=np.float64)
    total_width = 0.8
    width = total_width / n
    fig, ax = plt.subplots(figsize=(max(8.0, 1.1 * len(keys)), 4.2))
    for i, (label, vals) in enumerate(series):
        pos = x - total_width / 2 + (i + 0.5) * width
        ax.bar(pos, vals, width=width * 0.9,
               color=_SERIES_COLORS[i % len(_SERIES_COLORS)], label=label)
    ax.axhline(50.0, color=_INK_MUTED, linewidth=1, linestyle="--")
    ax.annotate("50% = no preference", xy=(-0.5, 50.0),
                xytext=(0, 4), textcoords="offset points", ha="left",
                fontsize=8, color=_INK_MUTED)
    ax.set_xticks(x, keys)
    ax.set_ylabel("% preferring ours", color=_INK)
    ax.set_ylim(0, 100)
    ax.spines[["top", "right"]].set_visible(False)
    ax.tick_params(colors=_INK_MUTED)
    ax.legend(frameon=False, fontsize=9, ncol=2)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None,
                   help="study results JSON (default: the paper's numbers)")
    p.add_argument("--out_dir", default="human_study_charts")
    args = p.parse_args(argv)

    if args.json:
        with open(args.json) as f:
            studies = json.load(f)
    else:
        studies = DEFAULT_STUDIES

    os.makedirs(args.out_dir, exist_ok=True)
    for i, study in enumerate(studies):
        render_pies(study, os.path.join(args.out_dir, f"pies_{i}.png"))
    render_bars(studies, os.path.join(args.out_dir, "preference_bars.png"))
    print(f"wrote {len(studies)} pie charts + preference_bars.png to {args.out_dir}")


if __name__ == "__main__":
    main()
