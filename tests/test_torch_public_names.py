"""Every public name of `pvderx` has its counterpart in `pvderx_torch`.

The comparison reads both packages' sources (the AST, no import). A
module's public names are the names it binds at module level that do not
start with ``_``: what it defines (``def``, ``class``, an assignment), what
its ``__all__`` lists, and what it re-exports, a name it imports from a
public module of its own package that is not itself a module. What it
merely imports is no public name of its own: a module (``import jax``,
``import numpy as np``, ``from pvderx.env import core as env_core``), a
name of another package, a helper of a private module (``pvderx._pytree``'s
``pytree_dataclass`` and ``replace`` in the modules that use them).

`pvderx/X.py` is held against `pvderx_torch/X.py` (`pvderx/_pytree.py`
against `pvderx_torch/_struct.py`, the port's container module), where
every binding counts, imports too: each name must be importable from there.
A name the port does not have stands in `EXCLUDED` with its reason.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "pvderx", ROOT / "pvderx_torch"

# reference module -> the port's counterpart, where the file names differ
COUNTERPART = {"_pytree.py": "_struct.py"}

_ORACLE = ("the port keeps its own `pvderx_torch/oracle.py`; the tests call "
           "the reference's numpy and scipy oracles directly")
_TPU = "TPU-only: "
_INTERNAL = ("imported for the module's own use, not re-exported by any "
             "caller; public in the port at `pvderx_torch.ode`")

# (reference module, name) -> why the port lacks it; a name of None
# excludes the whole module
EXCLUDED = {
    ("oracle/__init__.py", None): _ORACLE,
    ("oracle/scipy_ref.py", None): _ORACLE,
    ("oracle/supervisory_np.py", None): _ORACLE,
    ("ops/window.py", "LANE"): _TPU + "the TPU vreg's lane width (128), the "
                               "unit of the Pallas kernel's env blocks",
    ("ops/window.py", "MIN_BLOCK"): _TPU + "one f32 vreg tile (8 x 128 "
                                    "envs), the Pallas kernel's least block",
    ("env/vector.py", "RESET_CHUNK"): _TPU + "the env chunk of the reference's "
                                      "reset under XLA's compile-time "
                                      "memory; the port's reset runs the "
                                      "batch whole",
    ("diag/roofline.py", "V5E"): _TPU + "TPU v5e's published peaks; the "
                                 "port's roofline holds the H100's",
    ("diag/roofline.py", "vpu_utilization"): _TPU + "issued VPU operations "
                                             "over the v5e VPU's issue rate",
    ("diag/roofline.py", "TRANSCENDENTAL_PASSES"): _TPU + "the VPU passes "
                                                   "of one transcendental, "
                                                   "the weight of "
                                                   "`vpu_utilization`",
    ("ops/dualfloat.py", "dfp"): _TPU + "the Pallas kernel body's "
                                 "double-float namespace over vreg values; "
                                 "the port's DF ops are torch functions and "
                                 "`window_df.cu`",
    ("_pytree.py", "pytree_dataclass"): "JAX-only: registers a frozen "
                                        "dataclass as a JAX pytree; the "
                                        "port's containers are plain frozen "
                                        "dataclasses (`_struct.struct`)",
    ("physics/rhs_core.py", "jnp_int32"): "JAX-only: the int32 dtype of a "
                                          "jnp or dualfloat namespace, for "
                                          "`lax.broadcasted_iota`; the "
                                          "port's core runs on torch only",
    ("env/core.py", "rk4_window"): _INTERNAL,
    ("env/core.py", "trapezoid_window"): _INTERNAL,
    ("env/core.py", "backward_euler_window"): _INTERNAL,
    ("env/fleet.py", "rk4_window"): _INTERNAL,
    ("sim/dynamic.py", "newton_solve"): _INTERNAL,
}


def _is_module(pkg_dir: pathlib.Path, dotted: str) -> bool:
    path = pkg_dir.parent.joinpath(*dotted.split("."))
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


def _statements(body):
    """Module-level statements, into ``if`` / ``try`` blocks."""
    for node in body:
        yield node
        if isinstance(node, ast.If):
            yield from _statements(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _statements(node.body + node.orelse + node.finalbody
                                   + [s for h in node.handlers for s in h.body])


def _all_list(node, assigned):
    """The strings of an ``__all__`` list, ``*NAME`` spreading the keys of
    a dict (or the items of a list) assigned to NAME."""
    out = []
    for elt in node.elts:
        if isinstance(elt, ast.Constant):
            out.append(elt.value)
        elif isinstance(elt, ast.Starred) and isinstance(elt.value, ast.Name):
            val = assigned[elt.value.id]
            out += [k.value for k in (val.keys if isinstance(val, ast.Dict)
                                      else val.elts)]
    return out


def bindings(path: pathlib.Path, pkg_dir: pathlib.Path):
    """{name: kind} of a module: kind is "def", "all", "reexport" (a
    non-module name from a public module of the package), or "import"
    (anything else imported)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out, assigned, all_nodes = {}, {}, []
    pkg = pkg_dir.name
    for node in _statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = "def"
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out[n.id] = "def"
                        assigned[n.id] = node.value
                        if n.id == "__all__":
                            all_nodes.append(node.value)
        elif isinstance(node, ast.Import):
            for a in node.names:
                out.setdefault((a.asname or a.name).split(".")[0], "import")
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            mod = node.module or ""
            ours = node.level == 0 and mod.split(".")[0] == pkg
            private = any(p.startswith("_") for p in mod.split(".")[1:])
            for a in node.names:
                kind = ("reexport" if ours and not private and not _is_module(
                    pkg_dir, f"{mod}.{a.name}") else "import")
                out.setdefault(a.asname or a.name, kind)
    for node in all_nodes:
        for name in _all_list(node, assigned):
            out[name] = "all"
    return out


def public_names(path: pathlib.Path) -> set:
    return {n for n, kind in bindings(path, REF).items()
            if not n.startswith("_") and kind != "import"}


def _reference_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_torch_public_names_every_reference_name_is_ported_or_excluded():
    missing = {}
    for rel in _reference_modules():
        if (rel.split("/")[0] + "/__init__.py", None) in EXCLUDED or (
                rel, None) in EXCLUDED:
            continue
        port = PORT / COUNTERPART.get(rel, rel)
        names = public_names(REF / rel)
        have = set(bindings(port, PORT)) if port.exists() else set()
        lost = sorted(n for n in names - have if (rel, n) not in EXCLUDED)
        if lost:
            missing[rel] = lost
    assert not missing, f"public names of pvderx the port lacks: {missing}"


def test_torch_public_names_every_exclusion_is_live():
    """Each entry of `EXCLUDED` names a reference module that exists and,
    for a name, one that module makes public and the port lacks: an
    exclusion outlives neither the name nor its absence."""
    for (rel, name), why in EXCLUDED.items():
        assert why and (REF / rel).exists(), rel
        if name is None:
            continue
        port = PORT / COUNTERPART.get(rel, rel)
        assert name in public_names(REF / rel), (rel, name)
        assert not port.exists() or name not in bindings(port, PORT), (
            rel, name)


@pytest.mark.parametrize("rel,name,kind", [
    ("dist/sharding.py", "ENV_AXIS", "reexport"),      # from dist.mesh
    ("env/fleet.py", "N_ACTIONS", "reexport"),         # from env.core
    ("sim/dynamic.py", "env_core", "import"),          # a module, renamed
    ("env/core.py", "jnp", "import"),
    ("env/core.py", "pytree_dataclass", "import"),     # a private helper
    ("__init__.py", "check_parameters", "all"),        # `*_LAZY` in __all__
    ("env/gym_adapter.py", "register_envs", "def"),
])
def test_torch_public_names_tells_imports_from_public_names(rel, name, kind):
    assert bindings(REF / rel, REF)[name] == kind
    assert (name in public_names(REF / rel)) == (kind != "import")


# ---------------------------------------------------------------------------
# the names this slice ported, held against the reference in float64
# ---------------------------------------------------------------------------
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

PHYS_TOL = 1e-12      # relative to max |reference|
STEP_TOL = 1e-9       # as tests/test_torch_env.py


def _phys_inputs(preset):
    """Reference and port params/exog of ``preset`` at a perturbed operating
    point (tests/test_physics.py:99-107), and the state y [n_s]."""
    from pvderx.params import make_params as jmake, nominal_exog as jnominal
    from pvderx.physics import rhs_core as ref_core
    from pvderx_torch.params import DERParams, Exog

    p = jmake(preset)
    u = dataclasses.replace(jnominal(), v_g=0.9, q_ref=0.1, phi_g=0.2)
    y = ref_core.steady_state_guess(p, u, np) * 1.01
    f = lambda v: torch.tensor(v, dtype=torch.float64)
    pt = DERParams(**{k.name: (getattr(p, k.name) if k.name == "n_ph"
                               else f(getattr(p, k.name)))
                      for k in dataclasses.fields(p)})
    ut = Exog(**{k.name: f(getattr(u, k.name)) for k in dataclasses.fields(u)})
    return (p.astype(jnp.float64), u.astype(jnp.float64), pt, ut,
            np.asarray(y, np.float64))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                       1e-300)


@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_physics_bindings_match_the_reference(preset):
    """`pvderx_torch.physics`' rhs, rhs_jacobian (against `jax.jacfwd`),
    algebra, pv_power and steady_state_guess against `pvderx.physics`."""
    from pvderx import physics as jphys
    from pvderx_torch import physics

    pj, uj, pt, ut, y = _phys_inputs(preset)
    t = 0.3
    yt, tt = torch.from_numpy(y), torch.tensor(t, dtype=torch.float64)
    assert _rel(physics.rhs(yt, tt, pt, ut), jphys.rhs(
        jnp.asarray(y), jnp.float64(t), pj, uj)) <= PHYS_TOL
    jac = physics.rhs_jacobian(yt, tt, pt, ut)
    want = jax.jacfwd(lambda yy: jphys.rhs(yy, jnp.float64(t), pj, uj))(
        jnp.asarray(y))
    assert jac.shape == (pt.n_states, pt.n_states)
    assert _rel(jac, want) <= PHYS_TOL
    g_t = physics.algebra(yt, tt, pt, ut)
    g_j = jphys.algebra(jnp.asarray(y), jnp.float64(t), pj, uj)
    assert type(g_t) is physics.Algebra
    assert g_t._fields == g_j._fields
    for a, b in zip(jax.tree.leaves(tuple(g_j)),
                    [x for v in g_t for x in (v if isinstance(v, tuple)
                                              else (v,))]):
        assert np.abs(np.asarray(b) - np.asarray(a)).max() <= PHYS_TOL * max(
            np.abs(np.asarray(a)).max(), 1.0)
    vdc = torch.tensor([0.9, 1.0, 1.1], dtype=torch.float64)
    assert _rel(physics.pv_power(vdc, ut.s_irr, ut.t_cell, pt),
                jphys.pv_power(jnp.asarray(vdc.numpy()), uj.s_irr,
                               uj.t_cell, pj)) <= PHYS_TOL
    assert _rel(physics.steady_state_guess(pt, ut),
                jphys.steady_state_guess(pj, uj)) <= PHYS_TOL
    di, *_ = physics.unpack(yt, pt.n_ph)
    assert torch.equal(di.re, jphys.rhs_core.unpack(yt, pt.n_ph)[0].re)


def test_torch_rk4_step_matches_the_reference():
    from pvderx.ode.rk4 import rk4_step as jrk4_step
    from pvderx.physics import rhs_core as ref_core
    from pvderx_torch import physics
    from pvderx_torch.ode import rk4_step

    pj, uj, pt, ut, y = _phys_inputs("50")
    h = 1.0 / (60.0 * 48)
    got = rk4_step(lambda yy, tt: physics.rhs(yy, tt, pt, ut),
                   torch.from_numpy(y), torch.tensor(0.1, dtype=torch.float64),
                   h)
    want = jrk4_step(lambda yy, tt: ref_core.rhs(yy, tt, pj, uj, jnp),
                     jnp.asarray(y), jnp.float64(0.1), h)
    assert _rel(got, want) <= PHYS_TOL


def _env_pair(horizon):
    from pvderx.env import core as jcore
    from pvderx_torch.convert import state_from_numpy
    from pvderx_torch.env import make_env_config

    cfg_j = jcore.make_env_config("10", dtype=jnp.float64, n_sub=40,
                                  horizon=horizon)
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    st_j, _ = jax.vmap(lambda k: jcore.reset(cfg_j, k))(keys)
    cfg = make_env_config("10", dtype=torch.float64, n_sub=40,
                          horizon=horizon, device="cpu")
    st = state_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, st_j)),
                          cfg)
    return cfg_j, st_j, cfg, st


def _held(st, st_j, skip=("key",), path=""):
    """Every tensor leaf of the port's state against the reference's, by
    field name, but for ``skip`` (the reference's key; after a restart, the
    events, which each package draws with its own generator)."""
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(st_j, f.name, None)
        if f.name in skip:
            continue
        if dataclasses.is_dataclass(a):
            _held(a, b, skip, f"{path}{f.name}.")
        elif isinstance(a, torch.Tensor):
            np.testing.assert_allclose(
                a.double().numpy(), np.asarray(b, np.float64), rtol=0,
                atol=STEP_TOL, err_msg=path + f.name)


def test_torch_env_step_autoreset_matches_the_reference():
    """`env.core.step_autoreset` against `jax.vmap(core.step_autoreset)`:
    a 5-step horizon, so the last step truncates and restarts every env.
    The restart's events are drawn by each package's own generator
    (threefry against torch's), so the schedule is left out there; the
    restarted state, obs, reward and done are held."""
    from pvderx.env import core as jcore
    from pvderx_torch.env import core, step_autoreset

    assert step_autoreset is core.step_autoreset
    cfg_j, st_j, cfg, st = _env_pair(horizon=5)
    f = jax.jit(jax.vmap(lambda s, a: jcore.step_autoreset(cfg_j, s, a)))
    gen = torch.Generator().manual_seed(0)
    for k in range(5):
        a = ((k + np.arange(4)) % 5).astype(np.int32)
        st_j, obs_j, rew_j, done_j, _ = f(st_j, jnp.asarray(a))
        st, obs, rew, done, _ = core.step_autoreset(cfg, st,
                                                     torch.from_numpy(a), gen)
        for got, want in ((obs, obs_j), (rew, rew_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=STEP_TOL, err_msg=f"step {k}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
        _held(st, st_j, ("sched", "key") if k == 4 else ("key",))
    assert done.all() and torch.all(st.t_step == 0)
    assert torch.equal(st.y, st.y0) and torch.equal(obs, st.obs0)


def test_torch_fleet_step_autoreset_matches_the_reference():
    """`env.fleet.step_autoreset` against `jax.vmap(fleet.step_autoreset)`
    through a 4-step horizon (M = 3), as the single-DER case."""
    from pvderx.env import fleet as jfleet
    from pvderx_torch.convert import fleet_state_from_numpy
    from pvderx_torch.env import fleet, make_fleet_config

    fcj = jfleet.make_fleet_config("10", m=3, dtype=jnp.float64, n_sub=40,
                                   horizon=4)
    st_j, _ = jax.vmap(lambda k: jfleet.reset(fcj, k))(
        jax.random.split(jax.random.PRNGKey(5), 3))
    fc = make_fleet_config("10", m=3, dtype=torch.float64, n_sub=40,
                           horizon=4, device="cpu")
    st = fleet_state_from_numpy(
        dataclasses.asdict(jax.tree.map(np.asarray, st_j)), fc)
    f = jax.jit(jax.vmap(lambda s, a: jfleet.step_autoreset(fcj, s, a)))
    gen = torch.Generator().manual_seed(1)
    for k in range(4):
        a = ((k + np.arange(3)) % 5).astype(np.int32)
        st_j, obs_j, rew_j, done_j, _ = f(st_j, jnp.asarray(a))
        st, obs, rew, done, _ = fleet.step_autoreset(fc, st,
                                                      torch.from_numpy(a), gen)
        for got, want in ((obs, obs_j), (rew, rew_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=STEP_TOL, err_msg=f"step {k}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
        _held(st, st_j, ("sched", "key") if k == 3 else ("key",))
    assert done.all() and torch.all(st.t_step == 0)


def test_torch_unalias_copies_the_cached_buffers():
    from pvderx_torch.env import core

    cfg_j, st_j, cfg, st = _env_pair(horizon=5)
    st = dataclasses.replace(st, y0=st.y)          # reset's alias
    un = core.unalias(st)
    for name in ("y0", "obs0", "ppv0"):
        a, b = getattr(un, name), getattr(st, name)
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), name
    assert un.y0.data_ptr() != un.y.data_ptr()
    assert un.y is st.y and un.sched is st.sched


def test_torch_transition_is_the_references():
    from pvderx.learn.ppo import Transition as JTransition
    from pvderx_torch.learn.ppo import Transition

    assert Transition._fields == JTransition._fields


@pytest.mark.parametrize("module,name,source", [
    ("pvderx_torch", "PRESETS", "pvderx_torch.params"),
    ("pvderx_torch.ops", "rk4_window_batch", "pvderx_torch.ops.window"),
    ("pvderx_torch.ops", "pack_struct", "pvderx_torch.ops.window"),
    ("pvderx_torch.ops", "unpack_struct", "pvderx_torch.ops.window"),
    ("pvderx_torch.dist.sharding", "ENV_AXIS", "pvderx_torch.dist.mesh"),
    ("pvderx_torch.env.fleet", "N_ACTIONS", "pvderx_torch.env.core"),
    ("pvderx_torch.physics.fleet", "cscale", "pvderx_torch.physics.rhs_core"),
    ("pvderx_torch.env.gym_adapter", "register_envs", "pvderx_torch._gym_ids"),
])
def test_torch_reexports_are_the_same_objects(module, name, source):
    assert getattr(importlib.import_module(module), name) is getattr(
        importlib.import_module(source), name)


def test_torch_register_envs_is_idempotent_and_keeps_the_import_light():
    import gymnasium as gym
    from gymnasium.envs.registration import registry

    from pvderx_torch.env.gym_adapter import register_envs

    ids = ("pvderx_torch/PVDER-v0", "pvderx_torch/PVDERFleet-v0")
    before = {i: registry[i] for i in ids}
    register_envs()
    register_envs()
    assert {i: registry[i] for i in ids} == before
    assert registry["pvderx_torch/PVDER-v0"].vector_entry_point == (
        "pvderx_torch.env.gym_adapter:PVDERVectorEnv")
    env = gym.make("pvderx_torch/PVDER-v0", n_sub=40, device="cpu")
    assert env.reset(seed=0)[0].shape == (13,)
    code = ("import sys, pvderx_torch\n"
            "from gymnasium.envs.registration import registry\n"
            "assert 'pvderx_torch/PVDER-v0' in registry\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "'pvderx_torch.env')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
