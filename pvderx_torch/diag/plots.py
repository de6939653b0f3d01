"""Post-hoc plotting of collected simulation series (the counterpart of
`pvderx/diag/plots.py`): the reference's plot set (power / voltage /
current / duty cycle / frequency / DC link against t) from a series dict of
`pvderx_torch.sim.simulate` or `DynamicSimulation`.

matplotlib is imported inside the plotting method, so this module imports
where matplotlib is not installed.
"""
from __future__ import annotations

import numpy as np
import torch

PLOT_TYPES = ("power", "voltage", "current", "duty_cycle", "frequency", "dc",
              "all")


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


class SimulationResults:
    """Wraps a series dict (numpy arrays or tensors on any device)."""

    def __init__(self, series: dict, title: str = "PV-DER simulation"):
        self.series = {k: _host(v) for k, v in series.items()}
        self.title = title

    def plot_DER_simulation(self, plot_type: str = "power", save_path=None,
                            show: bool = False):
        if plot_type not in PLOT_TYPES:
            raise ValueError(f"plot_type must be one of {PLOT_TYPES}")
        import matplotlib
        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = self.series["t"]
        if plot_type == "all":
            # every plot type in one overview panel
            fig, axes = plt.subplots(3, 2, figsize=(12, 9), sharex=True)
            for ax, pt in zip(axes.flat, PLOT_TYPES[:-1]):
                self._draw(ax, t, pt)
                ax.legend(fontsize=8)
                ax.grid(True, alpha=0.3)
            for ax in axes[-1]:
                ax.set_xlabel("t [s]")
            fig.suptitle(self.title)
        else:
            fig, ax = plt.subplots(figsize=(8, 4))
            self._draw(ax, t, plot_type)
            ax.set_xlabel("t [s]")
            ax.legend()
            ax.grid(True, alpha=0.3)
            ax.set_title(f"{self.title}: {plot_type}")
        if save_path:
            fig.savefig(save_path, dpi=120, bbox_inches="tight")
        if show:  # pragma: no cover
            plt.show()
        plt.close(fig)
        return save_path

    def _draw(self, ax, t, plot_type):
        s = self.series
        if plot_type == "power":
            ax.plot(t, s["p_pcc"], label="P_PCC [pu]")
            ax.plot(t, s["q_pcc"], label="Q_PCC [pu]")
            ax.plot(t, s["p_pv"], label="P_PV [pu]", ls="--")
        elif plot_type == "voltage":
            ax.plot(t, s["v_mag"], label="|V_PCC| [pu]")
            ax.plot(t, s["vdc"], label="Vdc [pu]", ls="--")
        elif plot_type == "current":
            ax.plot(t, s["i_mag"], label="|i| [pu]")
        elif plot_type == "duty_cycle":
            ax.plot(t, s["m_mag"], label="|m|")
        elif plot_type == "frequency":
            ax.plot(t, 60.0 * s["f_meas"], label="f [Hz]")
        else:  # "dc"
            ax.plot(t, s["vdc"], label="Vdc [pu]")
