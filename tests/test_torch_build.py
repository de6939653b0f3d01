"""The kernels' library: its name and its C interface.

- `ops/_build.library_path` hashes every ``*.cu`` and ``*.cuh`` under
  ``csrc/`` with the nvcc flags, so an edit to a header shared by the kernels
  (``rhs.cuh``, ``df.cuh``, ``glue.cuh``) names a new library instead of
  loading a stale one.
- A source's own nvcc flags (`_build.SOURCE_FLAGS`) rename the library and
  reach that source's command only.
- Every ``extern "C"`` entry of ``csrc/*.cu``, parsed from the source text,
  has its argument and result types declared in `_build.ENTRIES` (what
  `_build.load` gives ctypes), parameter by parameter: an undeclared
  pointer would be passed as a 32-bit int and cut.
- Every public launcher of the port hands `_build.launch` its entry's
  arguments, minus the stream, in count and in kind (pointer, int or
  float), on ``meta`` tensors with the launch replaced by a recorder.
- `_build.launch` passes a tensor as its pointer, a tuple as a pointer
  array with nulls, a list as a double array and the stream last, raises
  with the library's error string on a nonzero code, and refuses tensors
  off the card, on two devices, not contiguous or requiring grad before
  it calls the library (a fake one here, with the device context and the
  current stream replaced).

No nvcc is needed: only names and source text are read.
"""
import contextlib
import ctypes
import re
import shutil
from types import SimpleNamespace

import pytest
import torch

from pvderx_torch.env import core
from pvderx_torch.native import kernels
from pvderx_torch.ops import (
    _build, autoreset, dualfloat, post_window, pre_window, window)


def test_torch_build_library_name_covers_every_device_source(tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    names = {p.name for p in src.iterdir()}
    assert {"rhs.cuh", "df.cuh", "glue.cuh", "window.cu", "fleet_window.cu",
            "window_df.cu", "native.cu", "autoreset.cu", "post_window.cu",
            "pre_window.cu"} <= names
    base = _build.library_path(src)
    assert base == _build.library_path()          # same sources, same name
    assert base.parent == _build.BUILD_DIR

    seen = {base}
    for name in ("rhs.cuh", "df.cuh", "glue.cuh", "window.cu",
                 "fleet_window.cu", "window_df.cu", "native.cu",
                 "autoreset.cu", "post_window.cu", "pre_window.cu"):
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
    """A source's own flags (`SOURCE_FLAGS`: the two glue kernels are
    compiled without FMA contraction) are part of the library's name and of
    that source's nvcc command only."""
    glue = ("post_window.cu", "pre_window.cu")
    assert _build.SOURCE_FLAGS == dict.fromkeys(glue, ["-fmad=false"])
    base = _build.library_path()
    for name in glue:
        monkeypatch.setitem(_build.SOURCE_FLAGS, name, [])
        assert _build.library_path() != base
        monkeypatch.setitem(_build.SOURCE_FLAGS, name, ["-fmad=false"])
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
        assert ("-fmad=false" in cmd) == (name in glue), name


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
            "pvderx_post_window", "pvderx_pre_window",
            "pvderx_error_string"} <= set(found)
    assert set(found) == set(_build.ENTRIES)
    for name, (res, params) in found.items():
        args, restype = _build.ENTRIES[name]
        assert [_C_TYPES[t] for t in params] == list(args), name
        assert _C_TYPES[res] is restype, name


# ---------------------------------------------------------------------------
# the one launch path
# ---------------------------------------------------------------------------
N, M = 5, 3
F32, F64 = torch.float32, torch.float64


def _m(*shape, dtype=F32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _single(dtype):
    """(y, t0, p_pack, u_pack) of a one-phase window on ``meta``."""
    return (_m(N, 11, dtype=dtype), _m(N, dtype=dtype),
            _m(len(window.P_FIELDS), N, dtype=dtype),
            _m(len(window.U_FIELDS), N, dtype=dtype))


def _autoreset_ins():
    shapes = {"uv": (N, 14), "y0": (N, 11), "obs0": (N, 13), "w_base": (),
              "solar": (N, 4, 3), "grid": (N, 4, 6), "load": (N, 2, 3),
              "y": (N, 11), "timers": (N, 6), "obs": (N, 13),
              "y_lo": (N, 11)}
    ins = {k: _m(*shapes.get(k, (N,))) for k in autoreset.IN_LEAVES}
    ins["done"] = _m(N, dtype=torch.bool)
    ins["t_step"] = _m(N, dtype=torch.int32)
    return ins


def _post_window_args():
    cfg = core.make_env_config("10", anomaly_detect=True, device="cpu")
    y, t, pk, uk = _single(F32)
    return ((y, t, _m(N, dtype=torch.int32), pk, uk, _m(N, 6), _m(N),
             _m(6), _m(6), _m(N), _m(N), post_window.step_constants(cfg)),
            dict(n_ph=1, horizon=cfg.horizon))


def _pre_window_args():
    """A Volt-VAR and MPPT pre-window's inputs on ``meta``."""
    cfg = core.make_env_config("10", voltvar_enable=True, mppt_enable=True,
                               device="cpu")
    y, _, pk, _ = _single(F32)
    ins = {k: _m(N) for k in pre_window.IN_LEAVES}
    ins.update(t_step=_m(N, dtype=torch.int32),
               action=_m(N, dtype=torch.int64), solar=_m(N, 4, 3),
               grid=_m(N, 4, 6), load=_m(N, 2, 3), y=y, p=pk)
    return ((ins, pre_window.pre_window_constants(cfg)),
            dict(n_ph=1, n_mppt=cfg.n_mppt, voltvar=True, mppt=True))


# launcher name -> (its C entry, a call on meta tensors)
LAUNCHERS = {
    "rk4_window_batch": ("pvderx_rk4_window", lambda: window.rk4_window_batch(
        *_single(F32), n_ph=1, n_sub=4, dt=1 / 60)),
    "rk4_fleet_window_batch": (
        "pvderx_rk4_fleet_window", lambda: window.rk4_fleet_window_batch(
            _m(N, M, 11), _m(N), _m(len(window.P_FIELDS), N, M),
            _m(len(window.U_FIELDS), N, M), n_ph=1, m=M, n_sub=4,
            dt=1 / 60)),
    "rk4_window_batch_df": (
        "pvderx_rk4_window_df", lambda: dualfloat.rk4_window_batch_df(
            _m(N, 11), *_single(F32), n_ph=1, n_sub=4, dt=1 / 60)),
    "rhs_batch": ("pvderx_native_rhs", lambda: kernels.rhs_batch(
        *_single(F64), n_ph=1)),
    "rk4_batch": ("pvderx_native_rk4_window", lambda: kernels.rk4_batch(
        *_single(F64), n_ph=1, n_sub=4, dt=1 / 60)),
    "dp54_batch": ("pvderx_native_dp54_window", lambda: kernels.dp54_batch(
        *_single(F64), n_ph=1, dt=1 / 60)),
    "newton_batch": (
        "pvderx_native_newton_steady", lambda: kernels.newton_batch(
            _single(F64)[0], *_single(F64)[2:], n_ph=1)),
    "autoreset_batch": ("pvderx_autoreset", lambda: autoreset.autoreset_batch(
        _autoreset_ins(), autoreset.scenario_constants(core.ScenarioConfig()),
        _m(1, dtype=torch.int64), n_ph=1)),
    "post_window_batch": (
        "pvderx_post_window", lambda: post_window.post_window_batch(
            *_post_window_args()[0], **_post_window_args()[1])),
    "pre_window_batch": (
        "pvderx_pre_window", lambda: pre_window.pre_window_batch(
            *_pre_window_args()[0], _m(1, dtype=torch.int64),
            **_pre_window_args()[1])),
}
_MODULES = (window, dualfloat, kernels, autoreset, post_window, pre_window)


def _kind(arg):
    """The C kind an argument of `_build.launch` passes as."""
    if arg is None or isinstance(arg, (torch.Tensor, tuple, list)):
        return "pointer"
    if isinstance(arg, bool):
        return "bool"
    return {int: "int", float: "float"}[type(arg)]


_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
          ctypes.c_float: "float", ctypes.c_double: "float"}


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_torch_launcher_hands_its_entry_the_declared_arguments(name,
                                                               monkeypatch):
    entry, call = LAUNCHERS[name]
    seen = []
    monkeypatch.setattr(_build, "launch", lambda *a, check=(): seen.append(
        (a, check)))
    launcher = next(getattr(m, name) for m in _MODULES if hasattr(m, name))
    launches = launcher.launches
    call()
    assert launcher.launches == launches + 1
    ((got_entry, what, *args), check), = seen
    assert got_entry == entry and isinstance(what, str)
    argtypes = _build.ENTRIES[entry][0]
    assert argtypes[-1] is ctypes.c_void_p              # the stream's
    assert [_kind(a) for a in args] == [_KINDS[t] for t in argtypes[:-1]]
    tensors = [t for a in args for t in (a if isinstance(a, tuple) else (a,))
               if isinstance(t, torch.Tensor)]
    assert {t.device.type for t in tensors} == {"meta"}
    assert all(all(isinstance(x, float) for x in a) for a in args
               if isinstance(a, list))
    assert check and all(o.is_floating_point() and any(o is t for t in tensors)
                         for o in check)


class _Cuda(torch.Tensor):
    """A CPU tensor that says it lives on the first card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Cuda1(_Cuda):
    @property
    def device(self):
        return torch.device("cuda", 1)


def test_torch_launch_passes_each_argument_as_its_c_type(monkeypatch):
    seen, entered, checked = {}, [], []

    class Lib:
        def pvderx_probe(self, *args):
            seen["args"] = args
            return seen.get("err", 0)

        def pvderx_error_string(self, err):
            return f"code {err}".encode()

    monkeypatch.setattr(_build, "load", Lib)
    monkeypatch.setattr(_build, "check_outputs",
                        lambda what, *outs: checked.append((what, outs)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib
                        .nullcontext(entered.append(dev)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=77))
    a = torch.arange(4.0).as_subclass(_Cuda)
    b = torch.zeros(3, dtype=torch.int32).as_subclass(_Cuda)
    _build.launch("pvderx_probe", "probe", a, (b, None, a), [0.5, 2.0], None,
                  7, 1.25, check=(a,))
    args = seen.pop("args")
    assert args[0] == a.data_ptr()
    assert args[1]._type_ is ctypes.c_void_p
    assert list(args[1]) == [b.data_ptr(), None, a.data_ptr()]
    assert args[2]._type_ is ctypes.c_double and list(args[2]) == [0.5, 2.0]
    assert args[3:] == (None, 7, 1.25, 77)              # the stream last
    assert entered == [torch.device("cuda", 0)]
    assert checked == [("probe", (a,))]
    seen["err"] = 3
    with pytest.raises(RuntimeError,
                       match="^probe kernel launch failed: code 3$"):
        _build.launch("pvderx_probe", "probe", a)
    assert len(checked) == 1                            # not after a failure
    seen.clear()
    refused = [
        ((torch.zeros(2),), ValueError, "unsupported device cpu"),
        ((a, (torch.zeros(2).as_subclass(_Cuda1),)), ValueError,
         "one device"),
        ((torch.zeros(4, 4)[:, 0].as_subclass(_Cuda),), ValueError,
         "contiguous"),
        ((torch.zeros(2, requires_grad=True).as_subclass(_Cuda),),
         RuntimeError, "no backward"),
    ]
    for args, exc, match in refused:
        with pytest.raises(exc, match=match):
            _build.launch("pvderx_probe", "probe", *args)
    assert not seen                                     # never called
