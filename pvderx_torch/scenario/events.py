"""Scenario / fault-injection events as dense time-sorted tables.

Each event type is a [K, D] table sorted by time, padded with t=+inf; the
active row is the last one with t_e ≤ t (row 0 is the mandatory t=0
baseline). A batch of envs stacks the tables to [N, K, D]. Lookup is O(K)
masked work with no data-dependent control flow (SPEC.md §8). Events apply at
control-step boundaries (zero-order hold, SPEC.md §3).
"""
from __future__ import annotations

import numpy as np
import torch

from pvderx_torch._struct import struct
from pvderx_torch.params import Exog, T_REF

# column layouts
SOLAR_COLS = 3   # (t, S_irr, T_cell)
GRID_COLS = 6    # (t, V_g, phi_g, dw_g, V_g2, phi_g2) — V_g2/phi_g2 are the
                 # negative-sequence (unbalance) component, 3-phase only
LOAD_COLS = 3    # (t, G_load, B_load)


@struct
class EventSchedule:
    """Dense event tables ([K, D] for one env, [N, K, D] for a batch)."""

    solar: torch.Tensor  # [..., K_s, 3]
    grid: torch.Tensor   # [..., K_g, 6]
    load: torch.Tensor   # [..., K_l, 3]


def active_row(table, t):
    """Last row with table[..., :, 0] <= t (row 0 must be the t=0 baseline).

    A one-hot masked sum, not a gather: rows are time-sorted, so `t_k <= t`
    is prefix-true and `le & ~le_next` selects exactly the last active row.
    ``table`` is [..., K, D] and ``t`` has the leading shape ``...``."""
    le = table[..., 0] <= t[..., None]
    last = le & ~torch.cat([le[..., 1:], torch.zeros_like(le[..., :1])], -1)
    # where, not multiply: the +inf padding rows would give inf * 0 = NaN
    return torch.where(last[..., None], table, 0.0).sum(-2)


def make_exog(sched: EventSchedule, t, vdc_ref, q_ref, conn, ces,
              p_ref=None) -> Exog:
    """Assemble the ZOH exogenous inputs for the window starting at t."""
    s = active_row(sched.solar, t)
    g = active_row(sched.grid, t)
    l = active_row(sched.load, t)
    return Exog(
        s_irr=s[..., 1], t_cell=s[..., 2],
        v_g=g[..., 1], phi_g=g[..., 2], dw_g=g[..., 3], t_g=g[..., 0],
        v_g2=g[..., 4], phi_g2=g[..., 5],
        g_load=l[..., 1], b_load=l[..., 2],
        vdc_ref=vdc_ref, q_ref=q_ref, conn=conn, ces=ces,
        p_ref=vdc_ref * 0.0 if p_ref is None else p_ref,
    )


class EventBuilder:
    """Host-side builder mirroring the reference's add_*_event API.

    >>> ev = EventBuilder()
    >>> ev.add_solar_event(10.0, 85.0, 300.0)   # (t, S_irr, T_cell)
    >>> ev.add_grid_event(15.0, v=0.5)
    >>> sched = ev.build(k_solar=4, k_grid=4, k_load=2, device="cpu")
    """

    def __init__(self, s_irr=1000.0, t_cell=T_REF, v=1.0, phi=0.0, dw=0.0,
                 g_load=0.0, b_load=0.0):
        self._solar = [(0.0, s_irr, t_cell)]
        self._grid = [(0.0, v, phi, dw, 0.0, 0.0)]
        self._load = [(0.0, g_load, b_load)]

    def add_solar_event(self, t, s_irr, t_cell=T_REF):
        self._solar.append((float(t), float(s_irr), float(t_cell)))

    def add_grid_event(self, t, v=1.0, phi=0.0, dw=0.0, v2=0.0, phi2=0.0):
        """v2/phi2: negative-sequence magnitude/angle (unbalanced sag,
        three-phase models only)."""
        self._grid.append((float(t), float(v), float(phi), float(dw),
                           float(v2), float(phi2)))

    def add_load_event(self, t, g_load=0.0, b_load=0.0):
        self._load.append((float(t), float(g_load), float(b_load)))

    def remove_solar_event(self, t):
        self._solar = [e for e in self._solar if e[0] != t or e[0] == 0.0]

    def remove_grid_event(self, t):
        self._grid = [e for e in self._grid if e[0] != t or e[0] == 0.0]

    def remove_load_event(self, t):
        self._load = [e for e in self._load if e[0] != t or e[0] == 0.0]

    def reset(self):
        """Drop every scripted event, keeping only the t=0 baselines."""
        self._solar = self._solar[:1]
        self._grid = self._grid[:1]
        self._load = self._load[:1]

    @staticmethod
    def _table(rows, k, cols, dtype, device):
        rows = [tuple(r) + (0.0,) * (cols - len(r)) for r in rows]
        rows = sorted(rows, key=lambda r: r[0])
        if len(rows) > k:
            raise ValueError(f"{len(rows)} events exceed table size {k}")
        out = np.full((k, cols), np.inf)
        out[: len(rows)] = np.asarray(rows)
        return torch.as_tensor(out, dtype=dtype, device=device)

    def build(self, k_solar=None, k_grid=None, k_load=None,
              dtype=torch.float32, device="cuda") -> EventSchedule:
        """Build the dense [K, D] tables of one env. Table sizes auto-size to
        the scripted events when omitted; pass explicit sizes to match a
        batched env config (cfg.k_solar/k_grid/k_load)."""
        k_s = max(len(self._solar), 2) if k_solar is None else k_solar
        k_g = max(len(self._grid), 2) if k_grid is None else k_grid
        k_l = max(len(self._load), 2) if k_load is None else k_load
        return EventSchedule(
            solar=self._table(self._solar, k_s, SOLAR_COLS, dtype, device),
            grid=self._table(self._grid, k_g, GRID_COLS, dtype, device),
            load=self._table(self._load, k_l, LOAD_COLS, dtype, device),
        )
