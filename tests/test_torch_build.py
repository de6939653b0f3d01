"""The kernels' library: its name and its C interface.

- `ops/_build.library_path` hashes every ``*.cu`` and ``*.cuh`` under
  ``csrc/`` with the nvcc flags, so an edit to a header shared by the kernels
  (``rhs.cuh``, ``df.cuh``) names a new library instead of loading a stale
  one.
- A source's own nvcc flags (`_build.SOURCE_FLAGS`) rename the library and
  reach that source's command only.
- Every ``extern "C"`` entry of ``csrc/*.cu``, parsed from the source text,
  has its argument and result types declared in `_build.ENTRIES` (what
  `_build.load` gives ctypes), parameter by parameter: an undeclared
  pointer would be passed as a 32-bit int and cut.

No nvcc is needed: only names and source text are read.
"""
import ctypes
import re
import shutil

import pytest

from pvderx_torch.ops import _build


def test_torch_build_library_name_covers_every_device_source(tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    names = {p.name for p in src.iterdir()}
    assert {"rhs.cuh", "df.cuh", "window.cu", "fleet_window.cu",
            "window_df.cu", "native.cu", "autoreset.cu",
            "post_window.cu"} <= names
    base = _build.library_path(src)
    assert base == _build.library_path()          # same sources, same name
    assert base.parent == _build.BUILD_DIR

    seen = {base}
    for name in ("rhs.cuh", "df.cuh", "window.cu", "fleet_window.cu",
                 "window_df.cu", "native.cu", "autoreset.cu",
                 "post_window.cu"):
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


def test_torch_build_source_flags_name_the_library_and_reach_nvcc(
        tmp_path, monkeypatch):
    """A source's own flags (`SOURCE_FLAGS`: post_window.cu is compiled
    without FMA contraction) are part of the library's name and of that
    source's nvcc command only."""
    assert _build.SOURCE_FLAGS == {"post_window.cu": ["-fmad=false"]}
    base = _build.library_path()
    monkeypatch.setitem(_build.SOURCE_FLAGS, "post_window.cu", [])
    assert _build.library_path() != base
    monkeypatch.setitem(_build.SOURCE_FLAGS, "post_window.cu", ["-fmad=false"])
    assert _build.library_path() == base
    calls = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            calls.append(cmd)
            self.returncode = 1

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    by_source = {cmd[-1].rsplit("/", 1)[-1]: cmd for cmd in calls}
    assert set(by_source) == {p.name for p in _build.CSRC.glob("*.cu")}
    for name, cmd in by_source.items():
        assert cmd[1:1 + len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
        assert ("-fmad=false" in cmd) == (name == "post_window.cu"), name


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "double": ctypes.c_double, "const char*": ctypes.c_char_p}


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
            "pvderx_rk4_window_df", "pvderx_native_rhs",
            "pvderx_native_rk4_window", "pvderx_native_dp54_window",
            "pvderx_native_newton_steady", "pvderx_autoreset",
            "pvderx_post_window", "pvderx_error_string"} <= set(found)
    assert set(found) == set(_build.ENTRIES)
    for name, (res, params) in found.items():
        args, restype = _build.ENTRIES[name]
        assert [_C_TYPES[t] for t in params] == list(args), name
        assert _C_TYPES[res] is restype, name
