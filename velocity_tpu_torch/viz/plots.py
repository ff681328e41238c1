"""Four-panel results visualization (reference plots.plotresults, plots.py:9-121).

A copy of ``velocity_tpu/viz/plots.py`` over the port's ``RunResult``
(``pipeline/speedest.py``), whose fields are numpy arrays already, and the
port's ``pipeline/report.py``.

Panels: (1) blended first/last frame with plate outline, ROI box, tracked
points and reprojections colored by frame; (2) camera-frame XZ trajectory;
(3) cumulative distance vs frame with polyfit; (4) speed vs frame with polyfit
(the MATLAB driver's smoothing, runExample.m:185-190).

Matplotlib instead of the reference's bokeh<3 (whose API is dead); writes PNG
and/or a self-contained HTML file with the image embedded.
"""

from __future__ import annotations

import base64
import io
from pathlib import Path

import numpy as np


def _poly_smooth(x, y, deg=2):
    deg = min(deg, len(x) - 1)
    if deg < 1:
        return y
    return np.polyval(np.polyfit(x, y, deg), x)


def plot_results(result, out_png: str | Path | None = None, show: bool = False):
    """Render the 4-panel report from a pipeline RunResult; returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    S, B = result.S, result.B
    n = S.shape[0]
    frames = np.arange(n)
    cmap = plt.get_cmap("viridis")

    fig = plt.figure(figsize=(14, 9))
    gs = fig.add_gridspec(2, 3, height_ratios=[2.0, 1.0])

    # --- panel 1: image + tracks ---
    ax = fig.add_subplot(gs[0, :])
    if result.first_gray is not None and result.last_gray is not None:
        blend = result.first_gray // 2 + result.last_gray // 2
        ax.imshow(blend, cmap="gray", interpolation="nearest")
    x0, x1, y0, y1 = result.roi_box
    ax.add_patch(
        __import__("matplotlib.patches", fromlist=["Rectangle"]).Rectangle(
            (x0, y0), x1 - x0, y1 - y0, fill=False, color="#00bcd4", lw=1.5,
            label="ROI",
        )
    )
    q = result.track_px[0, 0:4]
    ax.plot(
        np.append(q[:, 0], q[0, 0]), np.append(q[:, 1], q[0, 1]),
        "y.-", lw=2, ms=8, label="license outline",
    )
    for i in range(n):
        col = cmap(i / max(n - 1, 1))
        v = result.valid[i]
        ax.plot(result.track_px[i, v, 0], result.track_px[i, v, 1], ".",
                color=col, ms=2)
        pv = np.isfinite(result.proj_px[i, :, 0])
        ax.plot(result.proj_px[i, pv, 0], result.proj_px[i, pv, 1], "o",
                mfc="none", color=col, ms=4, alpha=0.4)
    ax.set_title(
        f"{result.camera.filename}   speed = {result.speed_kmh:.2f} "
        f"± {result.speed_std:.2f} km/h   residual = {result.residual_px:.3f} px"
    )
    ax.set_xlabel("pixel")
    ax.legend(loc="upper left", fontsize=8)

    # --- panel 2: XZ position ---
    ax = fig.add_subplot(gs[1, 0])
    ax.plot(B[:, 0], B[:, 2], ".-", color="#3f51b5")
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Z (m)")
    ax.set_title("camera-frame position")
    ax.axis("equal")

    # --- panel 3: distance ---
    ax = fig.add_subplot(gs[1, 1])
    ax.plot(frames, S[:, 7], ".", color="#3f51b5", label="distance")
    ax.plot(frames, _poly_smooth(frames, S[:, 7]), "-", color="#ff9800",
            label="polyfit")
    ax.set_xlabel("image")
    ax.set_ylabel("distance (m)")
    ax.legend(fontsize=8)

    # --- panel 4: speed ---
    ax = fig.add_subplot(gs[1, 2])
    sp = S[1:, 8]
    ax.plot(frames[1:], sp, ".-", color="#3f51b5", label="speed")
    if len(sp) > 3:
        ax.plot(frames[1:], _poly_smooth(frames[1:], sp), "-",
                color="#ff9800", label="polyfit")
    ax.set_xlabel("image")
    ax.set_ylabel("velocity (km/h)")
    ax.legend(fontsize=8)

    fig.tight_layout()
    if out_png:
        fig.savefig(out_png, dpi=110)
    if show:  # pragma: no cover
        plt.show()
    return fig


def save_results_html(result, out_html: str | Path):
    """Self-contained HTML report (PNG embedded base64 + the stats table)."""
    import matplotlib.pyplot as plt

    fig = plot_results(result)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110)
    plt.close(fig)
    img64 = base64.b64encode(buf.getvalue()).decode()

    from velocity_tpu_torch.pipeline import report

    rows = "\n".join(report.row(r) for r in result.S)
    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>velocity_tpu_torch — {result.camera.filename}</title></head>
<body style="font-family: monospace; background:#111; color:#ddd">
<h2>velocity_tpu_torch results — {result.camera.filename}</h2>
<img src="data:image/png;base64,{img64}" style="max-width:100%">
<pre>{report.header()}
{rows}
{report.summary(result.S)}</pre>
</body></html>"""
    Path(out_html).write_text(html)
    return str(out_html)
