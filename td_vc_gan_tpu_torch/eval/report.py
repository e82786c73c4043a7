"""HTML + JSON evaluation reports, reference-parity structure.

The port's own copy of ``td_vc_gan_tpu/eval/report.py``: the same HTML and
JSON, byte for byte, from the same results.

Re-design of test_scripts/common/build_html_parallel.py (664 LoC) and
build_html_nonparallel.py: consumes the pickled results written by
eval/mcd.py (``mcd_results``), eval/speaker_rec.py (``spkrec_results``),
eval/mosnet.py (``mosnet_results``) and eval/asr.py (``asr_results``) from a
test directory, and emits:

- a summary table per real-valued metric (mean, 95% CI, std, median,
  max, min — self-conversions excluded, build_html_parallel.py:198-215),
  plus speaker-recognition and ASR rates;
- the orig-vs-orig baseline table (the control condition);
- per-speaker-pair matrices for every metric (:373-396);
- histogram / boxplot / scatter / F0-ratio plots (matplotlib Agg,
  :402-560);
- parallel layout: per-phrase audio grids (originals row + src x tgt
  conversions) with per-cell metrics; nonparallel layout: one row per
  source utterance.

Output: ``index.html`` + machine-readable ``index.json`` sidecar.
"""

from __future__ import annotations

import html
import json
import pickle
from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# statistics over {src: {tgt: [values]}} matrices
# ---------------------------------------------------------------------------


def _flatten(matrix: dict, count_self: bool = False, transf=None) -> list:
    vals: list = []
    for src, row in matrix.items():
        for tgt, items in row.items():
            if src == tgt and not count_self:
                continue
            items = transf(items) if transf else items
            vals += [v for v in np.atleast_1d(items) if np.isfinite(v)]
    return vals


def dict_stats(matrix: dict, count_self: bool = False, transf=None) -> dict | None:
    """mean/ci95/std/median/max/min of a nested result matrix."""
    vals = _flatten(matrix, count_self, transf)
    if not vals:
        return None
    mean = float(np.mean(vals))
    sem = float(np.std(vals, ddof=1) / np.sqrt(len(vals))) if len(vals) > 1 else 0.0
    return {
        "mean": mean, "ci95": 1.96 * sem, "std": float(np.std(vals)),
        "median": float(np.median(vals)), "max": float(np.max(vals)),
        "min": float(np.min(vals)), "n": len(vals),
    }


def dict_stats_per_pair(matrix: dict) -> dict:
    out: dict = {}
    for src, row in matrix.items():
        out[src] = {}
        for tgt, items in row.items():
            finite = [v for v in items if np.isfinite(v)]
            out[src][tgt] = float(np.mean(finite)) if finite else float("nan")
    return out


def dict_correct_rate(class_matrix: dict) -> tuple[float, float]:
    """Fraction of nearest-mean classifications that hit the target."""
    hits: list[bool] = []
    for src, row in class_matrix.items():
        if isinstance(row, dict):
            for tgt, preds in row.items():
                hits += [p == tgt for p in preds]
        else:  # originals: per-source list
            hits += [p == src for p in row]
    if not hits:
        return float("nan"), float("nan")
    p = sum(hits) / len(hits)
    ci = 1.96 * np.sqrt(max(p * (1 - p), 1e-12) / len(hits))
    return p, float(ci)


def dict_correct_rate_per_pair(class_matrix: dict) -> dict:
    out: dict = {}
    for src, row in class_matrix.items():
        out[src] = {tgt: (sum(p == tgt for p in preds) / len(preds) if preds
                          else float("nan"))
                    for tgt, preds in row.items()}
    return out


def load_dicts(test_dir) -> dict:
    """Merge the harness's pickled result files (build_html_parallel:585-597)."""
    merged: dict = {}
    for name in ("mcd_results", "spkrec_results", "mosnet_results", "asr_results"):
        path = Path(test_dir) / name
        if path.exists():
            with open(path, "rb") as f:
                merged.update(pickle.load(f))
    return merged


# ---------------------------------------------------------------------------
# plots (matplotlib, Agg)
# ---------------------------------------------------------------------------

_PLOT_SPECS = {
    "mcd_result_conv": ("Mel-cepstral distortion", None),
    "emb_dist": ("Speaker embedding similarity", (0, 1)),
    "mos_result_conv": ("Predicted MOS", (1, 5)),
    "diff_f0_mean": ("log-F0 difference", None),
}


def build_plots(results: dict, test_dir) -> list[str]:
    """Histograms + boxplots + scatter + F0-ratio histograms -> png names."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []
    test_dir = Path(test_dir)
    written: list[str] = []

    present = {k: _flatten(results[k]) for k in _PLOT_SPECS if k in results}
    present = {k: v for k, v in present.items() if v}
    if present:
        fig, axs = plt.subplots(1, len(present), figsize=(4 * len(present), 4),
                                squeeze=False)
        for ax, (key, vals) in zip(axs[0], present.items()):
            title, lims = _PLOT_SPECS[key]
            ax.hist(vals, bins=50, density=True)
            ax.set_title(title)
            if lims:
                ax.set_xlim(lims)
        fig.tight_layout()
        fig.savefig(test_dir / "histograms.png")
        plt.close(fig)
        written.append("histograms.png")

        fig, axs = plt.subplots(1, len(present), figsize=(2.5 * len(present), 4),
                                squeeze=False)
        for ax, (key, vals) in zip(axs[0], present.items()):
            ax.boxplot(vals)
            ax.set_title(_PLOT_SPECS[key][0])
            ax.set_xticks([])
        fig.tight_layout()
        fig.savefig(test_dir / "boxplots.png")
        plt.close(fig)
        written.append("boxplots.png")

    if "emb_dist" in results and "mos_result_conv" in results:
        sims = _flatten(results["emb_dist"])
        moss = _flatten(results["mos_result_conv"])
        if sims and moss and len(sims) == len(moss):
            fig, ax = plt.subplots()
            ax.scatter(sims, moss, s=8)
            ax.set(xlabel="Embedding similarity", ylabel="Predicted MOS",
                   xlim=(0, 1), ylim=(1, 5),
                   title="Embedding similarity vs predicted MOS")
            fig.savefig(test_dir / "embsim_mos_scatter.png")
            plt.close(fig)
            written.append("embsim_mos_scatter.png")

    if "f0_ratio" in results:
        series = [("f0_ratio", "Source/Converted")]
        if "f0_ratio_orig" in results:
            series.append(("f0_ratio_orig", "Source/Target"))
        fig, axs = plt.subplots(1, len(series), figsize=(5 * len(series), 4),
                                squeeze=False)
        for ax, (key, label) in zip(axs[0], series):
            vals = _flatten(results[key])
            if vals:
                ax.hist(vals, bins=np.linspace(0, 3, 76), density=True)
            ax.set_title(f"Ratio of mean F0 — {label}")
            ax.set(xlabel="Ratio", ylabel="Density")
        fig.tight_layout()
        fig.savefig(test_dir / "histograms_f0_ratio.png")
        plt.close(fig)
        written.append("histograms_f0_ratio.png")
    return written


# ---------------------------------------------------------------------------
# HTML assembly
# ---------------------------------------------------------------------------

_STYLE = """
  <style>
  body { font-family: sans-serif; margin: 1.5em; }
  table { border-collapse: collapse; margin: 0.6em 0; }
  th, td { border: 1px solid #666; padding: 3px 8px; text-align: center; }
  td.good { background: #cfc; } td.bad { background: #fcc; }
  audio { width: 140px; }
  </style>
"""

_METRIC_TITLES = {
    "mcd_result_conv": "Mel-cepstral distortion",
    "mcd_result_orig": "Mel-cepstral distortion (originals baseline)",
    "diff_f0_mean": "Diff of log mean F0",
    "diff_f0_var": "Diff of log var F0",
    "emb_dist": "Embedding cosine similarity",
    "mos_result_conv": "Predicted MOS",
    "f0_ratio": "F0 ratio source/converted",
    "f0_ratio_orig": "F0 ratio source/target",
}


def _fmt(v) -> str:
    return f"{v:.3f}" if v is not None and np.isfinite(v) else "&mdash;"


def _stats_row(label: str, s: dict | None) -> str:
    if s is None:
        return ""
    cells = "".join(f"<td>{_fmt(s[k])}</td>" for k in
                    ("mean", "ci95", "std", "median", "max", "min"))
    return f"<tr><td>{label}</td>{cells}</tr>\n"


def _stats_table(rows: str) -> str:
    head = ("<tr><th>Measure</th><th>Mean</th><th>CI95</th><th>Std</th>"
            "<th>Median</th><th>Max</th><th>Min</th></tr>")
    return f"<table>{head}{rows}</table>"


def _pair_table(matrix: dict, spks: list[str], name_fn) -> str:
    head = "<tr><th>src \\ tgt</th>" + "".join(
        f"<th>{html.escape(name_fn(t))}</th>" for t in spks) + "</tr>"
    body = ""
    for src in spks:
        cells = "".join(f"<td>{_fmt(matrix.get(src, {}).get(t, float('nan')))}</td>"
                        for t in spks)
        body += f"<tr><th>{html.escape(name_fn(src))}</th>{cells}</tr>\n"
    return f"<table>{head}{body}</table>"


def _summary_sections(results: dict, spks: list[str], name_fn) -> tuple[str, dict]:
    sidecar: dict = {}
    out = "<h2>Objective measures summary</h2>\n"
    if results.get("backend"):
        out += f"<p>Speaker-embedding backend: <b>{results['backend']}</b></p>\n"
        sidecar["spk_backend"] = results["backend"]
    if "test_class" in results:
        p, ci = dict_correct_rate(results["test_class"])
        out += f"<p><b>Speaker recognition correct rate</b>: {p:.3f} &pm; {ci:.3f}</p>\n"
        sidecar["spk_correct_rate"] = p
    for key in ("asr_results_wer", "asr_results_cer"):
        if key in results:
            out += f"<p><b>{key.replace('asr_results_', 'ASR ').upper()}</b>: {results[key]:.3f}</p>\n"
            sidecar[key] = results[key]

    rows = ""
    for key in ("mcd_result_conv", "diff_f0_mean", "diff_f0_var", "emb_dist",
                "mos_result_conv", "f0_ratio"):
        if key in results:
            s = dict_stats(results[key])
            rows += _stats_row(_METRIC_TITLES[key], s)
            sidecar[key] = s
            if key == "diff_f0_mean":
                s_abs = dict_stats(results[key], transf=np.abs)
                rows += _stats_row("Abs diff of log mean F0", s_abs)
                sidecar["abs_diff_f0_mean"] = s_abs
    out += "<p>Real-valued measures (self-conversions excluded):</p>"
    out += _stats_table(rows)

    baseline_rows = ""
    for key in ("mcd_result_orig", "f0_ratio_orig"):
        if key in results:
            s = dict_stats(results[key])
            baseline_rows += _stats_row(_METRIC_TITLES[key], s)
            sidecar[key] = s
    if baseline_rows:
        out += "<h3>Baseline: measures between original signals</h3>"
        out += _stats_table(baseline_rows)
    if "ref_class" in results:
        p, ci = dict_correct_rate(results["ref_class"])
        out += f"<p><b>Original-signal speaker recognition rate</b>: {p:.3f} &pm; {ci:.3f}</p>\n"
        sidecar["orig_spk_correct_rate"] = p

    out += "<h2>Per-transformation-pair measures</h2>\n"
    if "test_class" in results:
        out += "<h3>Speaker recognition correct rate</h3>"
        out += _pair_table(dict_correct_rate_per_pair(results["test_class"]), spks, name_fn)
    for key in ("mcd_result_conv", "mcd_result_orig", "diff_f0_mean",
                "emb_dist", "mos_result_conv"):
        if key in results:
            out += f"<h3>{_METRIC_TITLES[key]}</h3>"
            out += _pair_table(dict_stats_per_pair(results[key]), spks, name_fn)
    return out, sidecar


def _phrase_grid(phrase_id: str, phrase_idx: int, spks: list[str],
                 results: dict, name_fn, sig_dir: str = "signals",
                 n_phrases: int | None = None,
                 origs: dict | None = None, convs: dict | None = None) -> str:
    # Positional per-phrase indexing matches the reference
    # (build_html_parallel.py:117-139) and is only meaningful when the
    # per-pair lists hold one value per phrase; if a conversion went missing
    # the later entries would be misattributed, so show a dash instead.
    def cell_metric(key, src, tgt):
        vals = results.get(key, {}).get(src, {}).get(tgt, [])
        aligned = n_phrases is None or len(vals) == n_phrases
        return vals[phrase_idx] if aligned and phrase_idx < len(vals) else float("nan")

    def orig_name(spk):
        # actual scanned filename when available (custom --parse_regex
        # naming); reconstruct the default name otherwise
        if origs is not None:
            f = origs.get((phrase_id, spk))
            return f.name if f is not None else None
        return f"{phrase_id}-{spk}-X-orig.wav"

    def conv_name(src, tgt):
        if convs is not None:
            f = convs.get((phrase_id, src, tgt))
            return f.name if f is not None else None
        return f"{phrase_id}-{src}-{tgt}-conv.wav"

    def audio_cell(fname):
        if fname is None:
            return "<td>&mdash;</td>"
        return (f'<td><audio controls preload="none">'
                f'<source src="{sig_dir}/{fname}"/></audio></td>')

    out = f"<h3>Phrase {html.escape(str(phrase_id))}</h3>\n<table>"
    out += ("<tr><th></th>" + "".join(f"<th>{html.escape(name_fn(t))}</th>"
                                      for t in spks) + "</tr>")
    out += "<tr><th>Originals</th>" + "".join(
        audio_cell(orig_name(t)) for t in spks) + "</tr>\n"
    for src in spks:
        out += f"<tr><th rowspan=4>{html.escape(name_fn(src))}</th>" + "".join(
            audio_cell(conv_name(src, t)) for t in spks) + "</tr>\n"
        cls_cells = ""
        for t in spks:
            preds = results.get("test_class", {}).get(src, {}).get(t, [])
            if n_phrases is not None and len(preds) != n_phrases:
                preds = []
            if phrase_idx < len(preds):
                ok = preds[phrase_idx] == t
                cls_cells += (f'<td class="{"good" if ok else "bad"}">'
                              f"{html.escape(name_fn(preds[phrase_idx]))}</td>")
            else:
                cls_cells += "<td>&mdash;</td>"
        out += f"<tr>{cls_cells}</tr>\n"
        out += "<tr>" + "".join(
            f"<td>{_fmt(cell_metric('mcd_result_conv', src, t))}</td>"
            for t in spks) + "</tr>\n"
        out += "<tr>" + "".join(
            f"<td>{_fmt(cell_metric('emb_dist', src, t))}</td>"
            for t in spks) + "</tr>\n"
    out += "</table>\n<p>Rows per source: audio / predicted speaker / MCD / emb. similarity</p>"
    return out


def _scan_signals(test_dir, parse):
    """(phrase_ids, spks, origs, convs) via field-based enumeration — a
    custom --parse_regex naming must be FOUND, not reconstructed (the old
    '*-X-orig.wav' glob silently yielded an empty report for foreign
    names)."""
    from td_vc_gan_tpu_torch.eval.mcd import scan_wavs

    sig_dir = Path(test_dir) / "signals"
    if not sig_dir.exists():
        sig_dir = Path(test_dir)
    origs, convs = scan_wavs(sig_dir, parse)
    phrase_ids = sorted({k[0] for k in origs})
    spks = sorted({k[1] for k in origs})
    return phrase_ids, spks, origs, convs


def build_html_parallel(out_filename, test_dir, parse=None, name_fn=None,
                        results: dict | None = None) -> Path:
    """Parallel-corpus report: summary + per-pair tables + phrase grids."""
    from td_vc_gan_tpu_torch.eval.mcd import parse_fn as default_parse

    parse = parse or default_parse
    name_fn = name_fn or (lambda s: s)
    test_dir = Path(test_dir)
    results = results if results is not None else load_dicts(test_dir)
    phrase_ids, spks, origs, convs = _scan_signals(test_dir, parse)

    summary, sidecar = _summary_sections(results, spks, name_fn)
    plots = build_plots(results, test_dir)
    plot_html = "".join(f'<figure><img src="{p}" style="max-width:100%"/></figure>\n'
                        for p in plots)
    grids = "".join(_phrase_grid(pid, i, spks, results, name_fn,
                    "signals" if (test_dir / "signals").exists() else ".",
                    n_phrases=len(phrase_ids), origs=origs, convs=convs)
                    for i, pid in enumerate(phrase_ids))

    doc = (f"<!DOCTYPE html><html><head><title>td_vc_gan_tpu evaluation</title>"
           f"{_STYLE}</head><body><h1>Voice conversion evaluation</h1>"
           f"{summary}<h2>Plots</h2>{plot_html}<h2>Audio</h2>{grids}"
           f"</body></html>")
    out = Path(out_filename)
    out.write_text(doc)
    sidecar["phrases"] = phrase_ids
    sidecar["speakers"] = spks
    out.with_suffix(".json").write_text(json.dumps(sidecar, indent=1, default=float))
    return out


def build_html_nonparallel(out_filename, test_dir, parse=None, name_fn=None,
                           results: dict | None = None,
                           num_sigs: int | None = None) -> Path:
    """Nonparallel layout: one row per source utterance, columns = targets
    (build_html_nonparallel.py:56-96)."""
    from td_vc_gan_tpu_torch.eval.mcd import parse_fn as default_parse

    parse = parse or default_parse
    name_fn = name_fn or (lambda s: s)
    test_dir = Path(test_dir)
    results = results if results is not None else load_dicts(test_dir)
    sig_rel = "signals" if (test_dir / "signals").exists() else "."

    _, spks, origs, convs = _scan_signals(test_dir, parse)
    rows = sorted(origs)  # (phrase_id, src) keys, field-enumerated
    if num_sigs:
        rows = rows[:num_sigs]

    summary, sidecar = _summary_sections(results, spks, name_fn)
    body = "<table><tr><th>Phrase</th><th>Original</th>" + "".join(
        f"<th>&rarr; {html.escape(name_fn(t))}</th>" for t in spks) + "</tr>\n"
    for phrase_id, src in rows:
        body += (f"<tr><td>{html.escape(str(phrase_id))}<br/>"
                 f"{html.escape(name_fn(src))}</td>"
                 f'<td><audio controls preload="none">'
                 f'<source src="{sig_rel}/{origs[(phrase_id, src)].name}"/>'
                 f"</audio></td>")
        for t in spks:
            cf = convs.get((phrase_id, src, t))
            body += ("<td>&mdash;</td>" if cf is None else
                     f'<td><audio controls preload="none">'
                     f'<source src="{sig_rel}/{cf.name}"/></audio></td>')
        body += "</tr>\n"
    body += "</table>"

    plots = build_plots(results, test_dir)
    plot_html = "".join(f'<figure><img src="{p}" style="max-width:100%"/></figure>\n'
                        for p in plots)
    doc = (f"<!DOCTYPE html><html><head><title>td_vc_gan_tpu evaluation</title>"
           f"{_STYLE}</head><body><h1>Voice conversion evaluation (nonparallel)</h1>"
           f"{summary}<h2>Plots</h2>{plot_html}<h2>Audio</h2>{body}</body></html>")
    out = Path(out_filename)
    out.write_text(doc)
    out.with_suffix(".json").write_text(json.dumps(sidecar, indent=1, default=float))
    return out
