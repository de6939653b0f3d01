"""On-device rollouts with autoreset: `pvderx_torch.env.vector.rollout`, one
DER per env.

Traffic parameters: ``chunk_steps`` (the steps of one `rollout` call),
``check_chunks`` and ``check_envs`` (the sample the checks follow),
``trace_chunks`` (the chunks traced with ``--trace 1``). Actions are
uniform in 0..4, drawn on the device by the benchmark's policy from a
generator of its own; the program draws its events from another, both
seeded from ``--seed``.

Set-up: the env config, the reset (timed: ``reset_s``), one warm-up chunk.
Window: whole chunks until ``--seconds`` have passed, then a device sync;
``env_steps_per_s`` is every env step of the window over its length.
Before each chunk the benchmark keeps the sampled envs' state and both
generators' states (a few gathers per chunk), after it their rewards and
dones and the host clock's reading (``marks``, for `harness.host_window`).

Checks (`check`): the reset of the sampled envs (the event tables drawn,
the steady state, the first observation) against the reference's reset
from the same uniforms; and for a sample of the window's chunks, drawn from
the seed with the first, the last and the first to take the envs to
their horizon (`common.horizon_unit`: the 9th at horizon 600, after the
warm-up chunk), the reference follows the chunk from
the program's state at its start with the same actions and autoreset
uniforms (replayed from the saved generator states), and every step's
reward and done, the state and observation at the chunk's end and the
event tables drawn on the way are compared (a done, step count or trip
latch that differs reads as an infinite gap). With ``control=True`` the
reference in bfloat16 stands in the program's place.
"""
from __future__ import annotations

import math
import time

import numpy as np

from portbench.drivers import common

CHUNK_FIELDS = ("y", "t_step", "vdc_ref", "q_ref", "timers", "tripped",
                "ces", "solar", "grid", "load")
RESET_FIELDS = ("y0", "obs0", "s0", "tc0", "solar", "grid", "load")


class Driver:
    def __init__(self, cell):
        self.cell = cell
        tr = cell.traffic
        self.chunk = int(tr["chunk_steps"])
        self.layer, self.traced_steps = {}, 0
        self.attempted = self.failed = 0
        self.records = []
        self.marks = []
        self.trace_units = int(tr["trace_chunks"])

    # -- the program's side -------------------------------------------------
    def policy(self, obs, _generator):
        import torch

        return torch.randint(0, 5, (obs.shape[0],), generator=self.pol,
                             device=obs.device)

    def setup(self):
        import torch
        from pvderx_torch.env import make_batch_fns, rollout

        cell, dev = self.cell, self.cell.device
        self.cfg = common.program_config(cell.config, dev)
        reset_batch = make_batch_fns(self.cfg)[0]
        self.roll = rollout
        n = cell.n_envs
        self.gen = torch.Generator(device=dev).manual_seed(cell.seed_for(0))
        self.pol = torch.Generator(device=dev).manual_seed(cell.seed_for(1))
        self.gen_reset = self.gen.get_state()
        k = min(int(cell.traffic["check_envs"]), n)
        rows = np.random.default_rng(cell.seed_for(2)).choice(n, k,
                                                               replace=False)
        self.idx = torch.as_tensor(np.sort(rows), device=dev)
        t = time.perf_counter()
        state, obs = reset_batch(n, self.gen)
        self.reset_rows = common.state_rows(state, self.idx, RESET_FIELDS)
        common.sync(self.cell.device)
        self.layer["reset_s"] = time.perf_counter() - t
        self.const = {k: self.reset_rows[k] for k in RESET_FIELDS if k not in
                      ("solar", "grid", "load")}
        state, obs, _, _ = self.roll(self.cfg, state, obs, self.policy,
                                     self.chunk, self.gen)
        self.state, self.obs = state, obs
        common.sync(self.cell.device)

    def _keep(self):
        rows = common.state_rows(self.state, self.idx, CHUNK_FIELDS)
        rows["obs"] = self.obs.index_select(0, self.idx)
        return rows, self.gen.get_state(), self.pol.get_state()

    def window(self, seconds: float, capture=None) -> dict:
        common.sync(self.cell.device)
        t0 = time.perf_counter()
        self.marks = [t0]
        if capture is not None:
            capture.start()
        chunks = 0
        while True:
            kept = self._keep()
            self.state, self.obs, rews, dones = self.roll(
                self.cfg, self.state, self.obs, self.policy, self.chunk,
                self.gen)
            self.records.append((kept, rews.index_select(1, self.idx),
                                 dones.index_select(1, self.idx)))
            chunks += 1
            self.marks.append(time.perf_counter())
            if capture is not None and capture.unit():
                capture, self.traced_steps = None, capture.units * self.chunk
            if time.perf_counter() - t0 >= seconds:
                break
        self.end = self._keep()
        common.sync(self.cell.device)
        elapsed = time.perf_counter() - t0
        if capture is not None:
            self.traced_steps = capture.stop() * self.chunk
        steps = chunks * self.chunk * self.cell.n_envs
        self.attempted = steps
        return {"env_steps_per_s": steps / elapsed}

    def release(self):
        self.state = self.obs = self.cfg = self.roll = None
        common.release(self.cell.device)

    # -- the checks -----------------------------------------------------------
    def _replay(self, gen_state, pol_state):
        """The sampled envs' actions [T, R] and autoreset uniforms
        [T, R, 14] of one chunk, drawn again from the saved states."""
        import torch

        dev, n = self.cell.device, self.cell.n_envs
        gen = common.generator_at(gen_state, dev)
        pol = common.generator_at(pol_state, dev)
        dtype = getattr(torch, self.cell.config["dtype"])
        acts, uvs = [], []
        for _ in range(self.chunk):
            acts.append(torch.randint(0, 5, (n,), generator=pol, device=dev)
                        .index_select(0, self.idx))
            uvs.append(torch.rand((n, 14), generator=gen, dtype=dtype,
                                  device=dev).index_select(0, self.idx))
        return (torch.stack(acts).cpu().numpy(),
                torch.stack(uvs).cpu().numpy())

    def readings(self, control: bool = False) -> dict:
        """The numbers the checks compare (see the module docstring)."""
        import torch

        from portbench.reference import env as renv
        from portbench.reference.xp import NumpyXP, TorchXP, to_numpy

        spec = renv.make_spec(self.cell.config)
        fx, cx = NumpyXP(np.float64), renv.clock_namespace(spec)
        out = common.reset_readings(
            spec, common.reset_draws(self.cell, self.gen_reset, self.idx),
            common.to_reference(self.reset_rows), control)

        n_rec = len(self.records)
        ids = common.sample_ids(n_rec, int(self.cell.traffic["check_chunks"]),
                                self.cell.seed_for(3))
        at = common.horizon_unit(int(self.cell.config["horizon"]),
                                 self.chunk, 1)
        ids = sorted(set(ids) | ({at} if at < n_rec else set()))
        const = common.to_reference(self.const)
        starts, ends, acts, uvs, rews, dones = [], [], [], [], [], []
        for i in ids:
            (rows, gen_state, pol_state), rew, done = self.records[i]
            end = (self.records[i + 1][0] if i + 1 < n_rec else self.end)[0]
            a, uv = self._replay(gen_state, pol_state)
            starts.append({**common.to_reference(rows), **const})
            ends.append(common.to_reference(end))
            acts.append(a)
            uvs.append(uv)
            rews.append(rew.double().cpu().numpy())
            dones.append(done.cpu().numpy())
        start = common.cat_rows(starts)
        end = common.cat_rows(ends)
        acts, uvs = np.concatenate(acts, 1), np.concatenate(uvs, 1)
        rews, dones = np.concatenate(rews, 1), np.concatenate(dones, 1)
        ref_st, ref_obs, ref_rew, ref_done = renv.rollout(
            spec, fx, cx, renv.convert(start, fx, cx), acts, uvs)
        if control:
            bf = TorchXP(torch.bfloat16)
            c_st, c_obs, c_rew, c_done = renv.rollout(
                spec, bf, bf, renv.convert(start, bf, bf),
                torch.as_tensor(acts), bf.cast(uvs))
            end = {k: to_numpy(v) for k, v in c_st.items()}
            end["obs"], rews = to_numpy(c_obs), to_numpy(c_rew)
            dones = to_numpy(c_done) > 0.5
        # a done flag, step count or trip latch that differs reads as an
        # infinite gap of its step's reward or of the state at the end
        out.update(
            reward=common.max_abs(rews, ref_rew) if np.array_equal(
                dones, ref_done) else math.inf,
            chunk_state=common.max_abs(end["y"], ref_st["y"]) if (
                np.array_equal(end["t_step"], ref_st["t_step"])
                and np.array_equal(np.asarray(end["tripped"], np.float64),
                                   np.asarray(ref_st["tripped"], np.float64))
            ) else math.inf,
            chunk_obs=common.max_abs(end["obs"], ref_obs),
            schedule=max(out["schedule"], *(common.max_abs(end[k], ref_st[k])
                                            for k in ("solar", "grid",
                                                      "load"))))
        return out

    def check(self, control: bool = False) -> list:
        return common.checks(self.cell.limits, self.readings(control))
