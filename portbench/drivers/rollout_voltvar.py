"""On-device rollouts with autoreset of a configuration with Volt-VAR: the
`rollout` driver, with its checks' readings taken from
`portbench.reference.env_voltvar` in place of the frozen `env`.

Traffic parameters, set-up, window and checks are `rollout.Driver`'s: the
reset of the sampled envs, and the sampled chunks (the first, the last, two
drawn from the seed and the first to reach the horizon) followed by the
reference from the program's state at their start, with the same actions
and autoreset draws; with ``control=True`` the reference in bfloat16 in
the program's place. The reference's reset is the frozen one
(`env_voltvar.reset`: the curve first acts on the first window), so the
reset's readings are `common.reset_readings`' on the new reference's spec.
"""
from __future__ import annotations

import math

import numpy as np

from portbench.drivers import common, rollout


class Driver(rollout.Driver):
    def readings(self, control: bool = False) -> dict:
        """The numbers the checks compare (see the module docstring)."""
        import torch

        from portbench.reference import env_voltvar as ref
        from portbench.reference.xp import NumpyXP, TorchXP, to_numpy

        spec = ref.make_spec(self.cell.config)
        fx, cx = NumpyXP(np.float64), ref.clock_namespace(spec)
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
        ref_st, ref_obs, ref_rew, ref_done = ref.rollout(
            spec, fx, cx, ref.convert(start, fx, cx), acts, uvs)
        if control:
            bf = TorchXP(torch.bfloat16)
            c_st, c_obs, c_rew, c_done = ref.rollout(
                spec, bf, bf, ref.convert(start, bf, bf),
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
