"""The kernels' library: its name and its C interface.

- `ops/_build.library_path` hashes every ``*.cu`` and ``*.cuh`` under
  ``csrc/`` with the nvcc flags, so an edit to a header shared by the kernels
  (``rhs.cuh``, ``df.cuh``) names a new library instead of loading a stale
  one.
- Every ``extern "C"`` entry of ``csrc/*.cu``, parsed from the source text,
  has its argument and result types declared in `_build.ENTRIES` (what
  `_build.load` gives ctypes), parameter by parameter: an undeclared
  pointer would be passed as a 32-bit int and cut.

No nvcc is needed: only names and source text are read.
"""
import ctypes
import re
import shutil

from pvderx_torch.ops import _build


def test_torch_build_library_name_covers_every_device_source(tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    names = {p.name for p in src.iterdir()}
    assert {"rhs.cuh", "df.cuh", "window.cu", "fleet_window.cu",
            "window_df.cu"} <= names
    base = _build.library_path(src)
    assert base == _build.library_path()          # same sources, same name
    assert base.parent == _build.BUILD_DIR

    seen = {base}
    for name in ("rhs.cuh", "df.cuh", "window.cu", "fleet_window.cu",
                 "window_df.cu"):
        f = src / name
        text = f.read_text()
        f.write_text(text + "\n// edited\n")
        path = _build.library_path(src)
        assert path not in seen, name
        seen.add(path)
        f.write_text(text)
    assert _build.library_path(src) == base

    (src / "extra.cuh").write_text("#pragma once\n")   # a new header counts
    assert _build.library_path(src) != base


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "const char*": ctypes.c_char_p}


def _extern_c_entries():
    """{name: (result type, [parameter types])} of every extern "C"
    definition in csrc/*.cu, as C type strings."""
    out = {}
    pat = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*(\bpvderx_\w+)\s*\(([^)]*)\)')
    for src in sorted(_build.CSRC.glob("*.cu")):
        for res, name, params in pat.findall(src.read_text()):
            types = [re.sub(r"\s*\w+$", "", p.strip()).replace(" *", "*")
                     for p in params.split(",")]
            out[name] = (res.strip().replace(" *", "*"), types)
    return out


def test_torch_build_declares_every_c_entry():
    found = _extern_c_entries()
    assert {"pvderx_rk4_window", "pvderx_rk4_fleet_window",
            "pvderx_rk4_window_df", "pvderx_error_string"} <= set(found)
    assert set(found) == set(_build.ENTRIES)
    for name, (res, params) in found.items():
        args, restype = _build.ENTRIES[name]
        assert [_C_TYPES[t] for t in params] == list(args), name
        assert _C_TYPES[res] is restype, name
