"""JSON config store: DER parameter files, scenario files, env configs (the
counterpart of `pvderx/config.py:35-123`).

The port keeps its own copies of the reference's files under
`pvderx_torch/configs/`. JSON is the at-rest format; the typed dataclasses
(`DERParams`, `EnvConfig`, `EventSchedule`) are the runtime format.

Three file kinds:

- DER params:  {"preset": "10", "overrides": {...}}  or  {"fields": {...}}
               (the full flat DERParams field map, as `save_der` writes it)
- scenario:    {"solar": [[t, S, T], ...],
                "grid": [[t, V, phi, dw, V2, phi2], ...]   (V2/phi2
                         optional: negative-sequence unbalance, 3-phase),
                "load": [[t, G, B], ...]}  -> EventBuilder -> EventSchedule
- env config:  kwargs of `make_env_config` (+ optional "scen" ranges and a
               "der" block of either DER form above; "dtype" as "float32"
               or "float64")
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from pvderx_torch.params import DERParams, make_params
from pvderx_torch.scenario.events import EventBuilder

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _resolve(name_or_path: str, subdir: str = "") -> str:
    """Accept a bare name ('der_10kW'), a packaged file, or a path."""
    if os.path.exists(name_or_path):
        return name_or_path
    base = (name_or_path if name_or_path.endswith(".json")
            else name_or_path + ".json")
    packaged = os.path.join(CONFIG_DIR, subdir, base)
    if os.path.exists(packaged):
        return packaged
    raise FileNotFoundError(
        f"no config {name_or_path!r} (looked at {packaged!r}); "
        f"packaged: {sorted(os.listdir(os.path.join(CONFIG_DIR, subdir)))}")


def _der_from_doc(doc: dict, **extra_overrides) -> DERParams:
    if "fields" in doc:
        fields = {**doc["fields"], **extra_overrides}
        fields["n_ph"] = int(fields["n_ph"])
        return DERParams(**fields)
    return make_params(doc["preset"],
                       **{**doc.get("overrides", {}), **extra_overrides})


def load_der(name_or_path: str, **extra_overrides) -> DERParams:
    """Load a DERParams (Python-float leaves) from a packaged or user JSON
    file."""
    with open(_resolve(name_or_path)) as f:
        return _der_from_doc(json.load(f), **extra_overrides)


def save_der(p: DERParams, path: str) -> str:
    """Write the full flat field map (round-trips through `load_der`)."""
    fields = {f.name: (int(v) if f.name == "n_ph" else float(v))
              for f in dataclasses.fields(p) for v in [getattr(p, f.name)]}
    with open(path, "w") as f:
        json.dump({"fields": fields}, f, indent=2, sort_keys=True)
    return path


def load_scenario(name_or_path: str, dtype=torch.float32, k_solar: int = 8,
                  k_grid: int = 8, k_load: int = 4, device="cuda"):
    """Load an event schedule from JSON. Returns (EventBuilder,
    EventSchedule), the schedule's [K, D] tables on ``device``."""
    with open(_resolve(name_or_path, "scenarios")) as f:
        doc = json.load(f)
    ev = EventBuilder()
    for row in doc.get("solar", []):
        if row[0] == 0.0:
            ev._solar = [tuple(map(float, row))]
        else:
            ev.add_solar_event(*row)
    for row in doc.get("grid", []):
        if row[0] == 0.0:
            ev._grid = [tuple(map(float, row))]
        else:
            ev.add_grid_event(row[0], *row[1:])
    for row in doc.get("load", []):
        if row[0] == 0.0:
            ev._load = [tuple(map(float, row))]
        else:
            ev.add_load_event(row[0], *row[1:])
    return ev, ev.build(k_solar=k_solar, k_grid=k_grid, k_load=k_load,
                        dtype=dtype, device=device)


def load_env_config(name_or_path: str, dtype=None, device="cuda",
                    **overrides):
    """Build an EnvConfig on ``device`` from an env JSON (see
    `pvderx_torch/configs/env_*.json`); ``dtype`` overrides the file's."""
    from pvderx_torch.env import core

    with open(_resolve(name_or_path)) as f:
        doc = json.load(f)
    kw = {k: v for k, v in doc.items() if not k.startswith("_")}
    der_doc = kw.pop("der", None)
    scen_doc = kw.pop("scen", None)
    kw.update(overrides)
    if dtype is not None:
        kw["dtype"] = dtype
    elif "dtype" in kw:
        kw["dtype"] = DTYPES[kw["dtype"]]
    if der_doc is not None:
        kw["der"] = _der_from_doc(der_doc)
    if scen_doc is not None:
        kw["scen"] = core.ScenarioConfig(**scen_doc)
    return core.make_env_config(device=device, **kw)


__all__ = ["CONFIG_DIR", "load_der", "save_der", "load_scenario",
           "load_env_config"]
