"""Live run dashboard — headless equivalent of the reference's in-window
Makie Observables figures (simulation/TwoLayerSimulation.jl:44-70 updates a
KE time series + q/psih heatmaps every frame while the run progresses).

Accelerator hosts run headless, so instead of a GL window the dashboard atomically
rewrites ``live.png`` + a self-refreshing ``live.html`` in the run
directory every ``every`` frames; point any browser (or an IDE preview) at
the file to watch the run. Costs one device->host transfer of the plotted
fields per refresh — amortised by ``every``.
"""
from __future__ import annotations

import os
import time

import numpy as np

__all__ = ["LiveDashboard"]

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="{refresh}">
<title>live: {title}</title>
<style>body{{background:#111;color:#eee;font-family:monospace;
text-align:center}}img{{max-width:95vw}}</style></head>
<body><h3>{title} — step {step}, t = {t:.3f} (refreshes every
{refresh}s)</h3><img src="live.png?v={stamp}"></body></html>
"""


class LiveDashboard:
    """Attach to a driver loop::

        dash = LiveDashboard(out_dir, title="rsw 512^2")
        ...
        dash.update(sim, grid, diag_times, diag_series)   # each frame

    Renders (when due): heatmap of the advecting-field vorticity proxy,
    packet scatter (if packets present), and the recorded diagnostic
    series.
    """

    def __init__(self, out_dir: str, title: str = "run", every: int = 1,
                 refresh_s: int = 5):
        self.out_dir = out_dir
        self.title = title
        self.every = max(int(every), 1)
        self.refresh_s = refresh_s
        self._count = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, sim, grid, diag_times=None, diag_series=None) -> bool:
        self._count += 1
        if (self._count - 1) % self.every:
            return False
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        has_packets = getattr(sim, "packets", None) is not None
        ncols = 2 + bool(diag_series)
        fig, axes = plt.subplots(1, ncols, figsize=(4.2 * ncols, 3.6))
        axes = np.atleast_1d(axes)

        # vorticity proxy from the interpolation fields: vx - uy (channels
        # 3/4 of the base block in both the 5-channel and the bicubic
        # 20-channel [f|fx|fy|fxy] layouts)
        fields = np.asarray(sim.fields)
        zeta = fields[4] - fields[3]
        ext = [float(grid.x[0]), float(grid.x[-1]),
               float(grid.y[0]), float(grid.y[-1])]
        m = np.abs(zeta).max() or 1.0
        axes[0].imshow(zeta, origin="lower", extent=ext, cmap="RdBu_r",
                       vmin=-m, vmax=m)
        axes[0].set_title("vorticity")

        if has_packets:
            x = np.asarray(sim.packets.x)
            y = np.asarray(sim.packets.y)
            kmag = np.hypot(np.asarray(sim.packets.k),
                            np.asarray(sim.packets.l))
            n = len(x)
            sel = slice(None) if n <= 5000 else slice(0, n, n // 5000)
            sc = axes[1].scatter(x[sel], y[sel], c=kmag[sel], s=2,
                                 cmap="viridis")
            fig.colorbar(sc, ax=axes[1], label="|k|")
            axes[1].set_xlim(ext[0], ext[1])
            axes[1].set_ylim(ext[2], ext[3])
            axes[1].set_title(f"packets ({n})")
        else:
            axes[1].axis("off")

        if diag_series:
            for name, series in diag_series.items():
                if len(series):
                    axes[2].plot(diag_times[:len(series)],
                                 np.asarray(series, dtype=float),
                                 label=name)
            axes[2].legend(fontsize=7)
            axes[2].set_xlabel("t")
            axes[2].set_title("diagnostics")

        step = int(sim.clock.step)
        t = float(sim.clock.t)
        fig.suptitle(f"{self.title}   step {step}   t={t:.3f}")
        fig.tight_layout()
        tmp = os.path.join(self.out_dir, ".live.png.tmp")
        fig.savefig(tmp, dpi=90, format="png")
        plt.close(fig)
        os.replace(tmp, os.path.join(self.out_dir, "live.png"))
        with open(os.path.join(self.out_dir, "live.html"), "w") as f:
            f.write(_HTML.format(title=self.title, step=step, t=t,
                                 refresh=self.refresh_s,
                                 stamp=int(time.time() * 1000)))
        return True
