"""The kernels' library is named by every device source it is built from.

`ops/_build.library_path` hashes every ``*.cu`` and ``*.cuh`` under
``csrc/`` with the nvcc flags, so an edit to a header shared by the kernels
(``rhs.cuh``) names a new library instead of loading a stale one. No nvcc
is needed: only the names are computed.
"""
import shutil

from pvderx_torch.ops import _build


def test_torch_build_library_name_covers_every_device_source(tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    names = {p.name for p in src.iterdir()}
    assert {"rhs.cuh", "window.cu", "fleet_window.cu"} <= names
    base = _build.library_path(src)
    assert base == _build.library_path()          # same sources, same name
    assert base.parent == _build.BUILD_DIR

    seen = {base}
    for name in ("rhs.cuh", "window.cu", "fleet_window.cu"):
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
