"""PPO training on the single-DER env: `pvderx_torch.learn.make_ppo`'s
``train_step``, run as its two public phases, ``collect`` and ``update``.

Traffic parameters: ``n_envs``, ``ppo`` (the `PPOConfig`), ``hidden``,
``check_envs`` (the envs whose transitions the checks follow),
``trace_steps`` (the train steps traced with ``--trace 1``).

Set-up builds one runner (`init_runner` from the seed), puts the
benchmark's own initial weights into its net (drawn on the device from the
seed in one call), and drives it through its first three train steps by
the window's own calls: ``collect`` then ``update``. It keeps what the
checks need: the sampled envs' state and the generator's state before each
collect, each rollout, the loss, the first gradient as Adam got it (from
Adam's first moment after its first step, by a step hook), and the
parameters after the three. The same runner then goes on into the window.
Window: train steps until ``--seconds`` have passed, then a device sync;
``train_env_steps_per_s`` is every env step collected in the window over
its length. One train step of the window is kept for the checks as well:
the first whose collect takes the envs to the horizon (`horizon_unit`;
the 35th at horizon 600 and 16-step collects), so that the horizon's
autoreset inside ``collect`` is checked; before it the sampled envs' state,
the generator's state, the parameters and Adam's state are copied on the
device, after it its rollout, loss and parameters are kept. A window too
short to reach that step is followed by untimed train steps up to it.
With ``--trace 1``, once the traced steps are done, the host clock times
each ``collect`` and ``update`` call between device syncs:
``ppo_collect_ms`` and ``ppo_update_ms`` are their means (the untraced
run, which reports the rate, has no such syncs).

Checks: the reset (as in the rollout driver); for each of the first three
train steps and the window's kept step, the sampled envs' transitions
followed by the reference from the program's state with the program's
actions and the replayed draws (rewards, dones, next observations), and
the program's log-probabilities and values against the reference net's.
The updates: the reference (float64, from the same initial weights,
chaining its own parameters) runs the first three updates on the
program's rollouts with the replayed minibatch permutations; compared are
each step's loss, the first gradient by the worst leaf, and the
parameters' change after the three by the worst leaf (each leaf's norm
against the reference's, over the larger of that leaf's and the median
leaf's reference norm; leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change). The window's
kept step is followed from the program's parameters and Adam state before
it (the reference cannot reach them otherwise): its loss, and its change
of the parameters by the worst leaf (``window_update``). The updates take
the program's rollout of every env as their input; its sampled envs are
the ones checked against the reference env.
"""
from __future__ import annotations

import math
import time

import numpy as np

from portbench.drivers import common

STATE_FIELDS = ("y", "t_step", "vdc_ref", "q_ref", "timers", "tripped",
                "ces", "solar", "grid", "load", "y0", "obs0", "s0", "tc0")
RESET_FIELDS = ("y0", "obs0", "solar", "grid", "load")
FIRST = 3


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.layer, self.traced_steps = {}, 0
        self.attempted = self.failed = 0
        self.hp = dict(cell.traffic["ppo"])
        self.trace_units = int(cell.traffic["trace_steps"])
        self.check_at = common.horizon_unit(int(cell.config["horizon"]),
                                            int(self.hp["rollout_len"]), FIRST)
        self.late = None
        self.marks = []

    def initial_weights(self, net) -> dict:
        """The benchmark's initial parameters for ``net``'s names and shapes:
        one normal draw on the device, each weight scaled by its gain over
        the root of its fan-in (sqrt(2) hidden, 0.01 logits, 1 value), each
        bias by 0.01."""
        import torch

        named = list(net.named_parameters())
        total = sum(p.numel() for _, p in named)
        gen = torch.Generator(device=self.cell.device).manual_seed(
            self.cell.seed_for(4))
        flat = torch.randn(total, generator=gen, device=self.cell.device)
        out, at = {}, 0
        for name, p in named:
            x = flat[at:at + p.numel()].reshape(p.shape)
            at += p.numel()
            if name.endswith("weight"):
                gain = {"logits": 0.01, "value": 1.0}.get(
                    name.split(".")[0], 2 ** 0.5)
                x = x * (gain / p.shape[1] ** 0.5)
            else:
                x = x * 0.01
            out[name] = x.to(p.dtype)
        return out

    def setup(self):
        import torch
        from pvderx_torch.learn import PPOConfig, make_ppo

        cell, dev, n = self.cell, self.cell.device, self.cell.n_envs
        cfg = common.program_config(cell.config, dev)
        init_runner, self.train_step, make_net = make_ppo(
            cfg, PPOConfig(**self.hp), hidden=tuple(cell.traffic["hidden"]))
        gen = torch.Generator(device=dev).manual_seed(cell.seed_for(0))
        # where the runner's reset starts drawing: after its net's init
        probe = common.generator_at(gen.get_state(), dev)
        make_net(generator=probe)
        self.gen_reset = probe.get_state()
        runner = init_runner(n, gen)
        self.theta0 = self.initial_weights(runner.net)
        with torch.no_grad():
            for name, p in runner.net.named_parameters():
                p.copy_(self.theta0[name])
        k = min(int(cell.traffic["check_envs"]), n)
        self.rows = np.sort(np.random.default_rng(cell.seed_for(2)).choice(
            n, k, replace=False))
        self.idx = torch.as_tensor(self.rows, device=dev)
        self.reset_rows = common.state_rows(runner.env_state, self.idx,
                                            RESET_FIELDS)
        first_grad = {}

        def hook(opt, *_):
            if not first_grad:
                b1 = opt.param_groups[0]["betas"][0]
                names = {id(p): k for k, p in runner.net.named_parameters()}
                for p, s in opt.state.items():
                    first_grad[names[id(p)]] = s["exp_avg"] / (1 - b1)

        handle = runner.opt.register_step_post_hook(hook)
        self.runner = runner
        self.first = [to_cpu(self._step(keep=True)[0]) for _ in range(FIRST)]
        handle.remove()
        self.first_grad = {k: v.detach().cpu() for k, v in first_grad.items()}
        self.theta3 = {k: p.detach().cpu().clone()
                       for k, p in self.runner.net.named_parameters()}
        self.theta0 = {k: v.cpu() for k, v in self.theta0.items()}
        common.sync(self.cell.device)

    def _step(self, keep: bool = False, time_it: bool = False):
        """One train step of the runner by its two public calls: (what the
        checks keep of it or None, (collect s, update s) by the host clock
        between device syncs or None)."""
        dev = self.cell.device
        kept = self._before() if keep else None
        if time_it:
            common.sync(dev)
            ta = time.perf_counter()
        self.runner, rollout = self.train_step.collect(self.runner)
        if time_it:
            common.sync(dev)
            tb = time.perf_counter()
        if keep:
            traj, _ = rollout
            kept.update(gen_update=self.runner.generator.get_state(), traj={
                "obs": traj.obs, "action": traj.action, "reward": traj.reward,
                "done": traj.done, "logp": traj.logp, "value": traj.value,
                "last_obs": self.runner.obs})
        self.runner, metrics = self.train_step.update(self.runner, rollout)
        if keep:
            kept.update(loss=metrics["loss"], theta_after={
                k: p.detach().clone()
                for k, p in self.runner.net.named_parameters()})
        if not time_it:
            return kept, None
        common.sync(dev)
        return kept, (tb - ta, time.perf_counter() - tb)

    def _before(self) -> dict:
        """Copies of what a train step starts from: the sampled envs'
        state, the generator's state, the parameters, Adam's moments and
        step count (device copies; no sync)."""
        runner = self.runner
        names = {id(p): k for k, p in runner.net.named_parameters()}
        m, v, t = {}, {}, 0
        for p, s in runner.opt.state.items():
            m[names[id(p)]] = s["exp_avg"].detach().clone()
            v[names[id(p)]] = s["exp_avg_sq"].detach().clone()
            t = int(s["step"])
        return {"start": common.state_rows(runner.env_state, self.idx,
                                           STATE_FIELDS),
                "gen_collect": runner.generator.get_state(),
                "theta": {k: p.detach().clone()
                          for k, p in runner.net.named_parameters()},
                "adam": (m, v, t)}

    def window(self, seconds: float, capture=None) -> dict:
        per_layer = capture is not None
        times = []
        common.sync(self.cell.device)
        t0 = time.perf_counter()
        self.marks = [t0]
        if capture is not None:
            capture.start()
        k = 0
        while True:
            kept, t = self._step(keep=k == self.check_at,
                                 time_it=per_layer and capture is None)
            self.late = kept or self.late
            if t is not None:
                times.append(t)
            k += 1
            self.marks.append(time.perf_counter())
            if capture is not None and capture.unit():
                capture_units, capture = capture.units, None
                self.traced_steps = capture_units * self.hp["rollout_len"]
            if time.perf_counter() - t0 >= seconds:
                break
        common.sync(self.cell.device)
        elapsed = time.perf_counter() - t0
        if capture is not None:
            self.traced_steps = capture.stop() * self.hp["rollout_len"]
        steps = k * self.hp["rollout_len"] * self.cell.n_envs
        while k <= self.check_at:
            self.late = self._step(keep=k == self.check_at)[0] or self.late
            k += 1
        if times:
            self.layer["ppo_collect_ms"] = 1e3 * float(np.mean(
                [a for a, _ in times]))
            self.layer["ppo_update_ms"] = 1e3 * float(np.mean(
                [b for _, b in times]))
        self.attempted = steps
        return {"train_env_steps_per_s": steps / elapsed}

    def release(self):
        self.runner = self.train_step = None
        self.late = to_cpu(self.late)
        common.release(self.cell.device)

    # -- the checks -----------------------------------------------------------
    def _replay(self, gen_state):
        """The sampled envs' autoreset uniforms [T, R, 14] of one collect,
        drawn again in the program's order (per step the sampler's
        exponentials for the N x A logits, then the events' uniforms), and
        the generator's state after them."""
        import torch

        dev, n = self.cell.device, self.cell.n_envs
        gen = common.generator_at(gen_state, dev)
        dtype = getattr(torch, self.cell.config["dtype"])
        uvs = []
        for _ in range(self.hp["rollout_len"]):
            torch.empty((n, 5), dtype=dtype, device=dev).exponential_(
                generator=gen)
            uvs.append(torch.rand((n, 14), generator=gen, dtype=dtype,
                                  device=dev).index_select(0, self.idx))
        return torch.stack(uvs).cpu().numpy()

    def _perms(self, gen_state):
        import torch

        gen = common.generator_at(gen_state, self.cell.device)
        rows = self.hp["rollout_len"] * self.cell.n_envs
        return [torch.randperm(rows, generator=gen, device=self.cell.device)
                for _ in range(self.hp["n_epochs"])]

    def readings(self, control: bool = False) -> dict:
        import torch

        from portbench.reference import env as renv
        from portbench.reference import ppo as rppo
        from portbench.reference.xp import NumpyXP, TorchXP, to_numpy

        spec = renv.make_spec(self.cell.config)
        dev = self.cell.device
        out = common.reset_readings(
            spec, common.reset_draws(self.cell, self.gen_reset, self.idx),
            common.to_reference(self.reset_rows), control)

        # the collected transitions of the sampled envs
        fx, cx = NumpyXP(np.float64), renv.clock_namespace(spec)
        bf = TorchXP(torch.bfloat16)
        rew_gap, obs_gap = 0.0, 0.0
        steps = self.first + [self.late]
        for f in steps:
            t = f["traj"]
            start = common.to_reference(f["start"])
            act = t["action"][:, self.rows].numpy()
            uvs = self._replay(f["gen_collect"])
            r = [t["reward"][:, self.rows].double().numpy(),
                 t["done"][:, self.rows].numpy() > 0.5,
                 torch.cat([t["obs"][1:], t["last_obs"][None]])[
                     :, self.rows].double().numpy()]
            ref = self._follow(spec, fx, cx, start, act, uvs)
            if control:
                c = self._follow(spec, bf, bf, start, act, uvs)
                r = [to_numpy(c[0]), to_numpy(c[1]) > 0.5, to_numpy(c[2])]
            # a done that differs reads as an infinite gap of the rewards
            rew_gap = max(rew_gap, common.max_abs(r[0], ref[0])
                          if np.array_equal(r[1], ref[1]) else math.inf)
            obs_gap = max(obs_gap, common.max_abs(r[2], ref[2]))
        out.update(reward=rew_gap, step_obs=obs_gap)

        # the updates
        def chain(dtype):
            params = {k: v.to(dev, dtype) for k, v in self.theta0.items()}
            opt = rppo.Adam(params, self.hp["lr"])
            steps = []
            for f in self.first:
                params, step = self._ref_update(params, opt, f, dtype)
                steps.append(step)
            return params, steps

        def late(dtype):
            """The window's kept step from the program's parameters and
            Adam state before it."""
            theta = self.late["theta"]
            params = {k: v.to(dev, dtype) for k, v in theta.items()}
            opt = rppo.Adam(params, self.hp["lr"], state=self.late["adam"])
            params, step = self._ref_update(params, opt, self.late, dtype)
            step["change"] = {k: params[k].double() - theta[k].to(
                dev).double() for k in theta}
            return step

        ref_params, ref_steps = chain(torch.float64)
        ref_late = late(torch.float64)
        got_loss = [float(f["loss"]) for f in steps]
        got_grad = self.first_grad
        got_delta = {k: self.theta3[k].double() - self.theta0[k].double()
                     for k in self.theta0}
        got_change = {k: self.late["theta_after"][k].double()
                      - self.late["theta"][k].double() for k in self.theta0}
        got_policy = [(f["traj"]["logp"], f["traj"]["value"]) for f in steps]
        if control:
            c_params, c_steps = chain(torch.bfloat16)
            c_late = late(torch.bfloat16)
            got_loss = [s["loss"] for s in c_steps + [c_late]]
            got_grad = c_steps[0]["grad"]
            got_delta = {k: c_params[k].double() - self.theta0[k].to(
                dev).double() for k in self.theta0}
            got_change = c_late["change"]
            got_policy = [(s["logp"], s["value"]) for s in c_steps + [c_late]]
        ref_delta = {k: ref_params[k] - self.theta0[k].to(dev).double()
                     for k in self.theta0}
        ref_all = ref_steps + [ref_late]
        out["loss"] = max(abs(a - s["loss"]) / abs(s["loss"])
                          for a, s in zip(got_loss, ref_all))
        out["policy"] = max(
            max(common.max_abs(to_numpy(a), to_numpy(s["logp"])),
                common.max_abs(to_numpy(b), to_numpy(s["value"])))
            for (a, b), s in zip(got_policy, ref_all))
        ref_grad = ref_steps[0]["grad"]
        out["first_grad"] = worst_leaf(got_grad, ref_grad)
        out["update"] = worst_leaf(got_delta, ref_delta, ref_grad)
        out["window_update"] = worst_leaf(got_change, ref_late["change"],
                                          ref_late["grad"])
        self.detail = {"loss": got_loss, "ref_loss": [s["loss"] for s in
                                                      ref_all],
                       "first_grad": leaf_gaps(got_grad, ref_grad),
                       "update": leaf_gaps(got_delta, ref_delta),
                       "window_update": leaf_gaps(got_change,
                                                  ref_late["change"]),
                       "window_step": self.check_at,
                       "window_dones": float(self.late["traj"]["done"][
                           :, self.rows].sum())}
        return out

    def _ref_update(self, params, opt, kept, dtype):
        """The reference's update on a kept step's rollout from ``params``
        and ``opt``: (params after, its loss, first clipped gradient, and
        the log-probabilities and values at ``params``)."""
        import torch

        from portbench.reference import ppo as rppo

        dev = self.cell.device
        traj = {k: v.to(dev) for k, v in kept["traj"].items()}
        traj["obs"] = traj["obs"].to(dtype)
        traj["last_obs"] = traj["last_obs"].to(dtype)
        with torch.no_grad():
            logits, value = rppo.forward(params, traj["obs"])
            logp, _ = rppo.logp_entropy(logits, traj["action"])
        params, loss, grad = rppo.update(
            params, opt, self.hp, traj, self._perms(kept["gen_update"]))
        return params, {"loss": float(loss), "grad": grad, "logp": logp,
                        "value": value}

    def _follow(self, spec, fx, cx, start, act, uvs):
        """The reference's (or the control's) rewards, dones and next
        observations [T, R(, 13)] of the sampled envs over one collect."""
        import torch

        from portbench.reference import env as renv

        st = renv.convert(start, fx, cx)
        rews, dones, obs = [], [], []
        a_all = act if fx.backend == "numpy" else torch.as_tensor(act)
        for a, uv in zip(a_all, uvs):
            st, o, r, d, _ = renv.step(spec, fx, cx, st, a, cx.cast(uv))
            rews.append(r)
            dones.append(d)
            obs.append(o)
        return fx.stack(rews), fx.stack(dones), fx.stack(obs)

    def check(self, control: bool = False) -> list:
        return common.checks(self.cell.limits, self.readings(control))


def to_cpu(x):
    """``x`` (a tensor, or a dict or tuple of them) with every device
    tensor copied to the host."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(to_cpu(v) for v in x)
    return x


def leaf_gaps(got: dict, ref: dict) -> dict:
    """Each leaf's (program norm, reference norm)."""
    import torch

    return {k: (float(torch.linalg.vector_norm(got[k].double().cpu()))
                if k in got else 0.0,
                float(torch.linalg.vector_norm(ref[k].double().cpu())))
            for k in ref}


def worst_leaf(got: dict, ref: dict, ref_grad: dict | None = None) -> float:
    """The largest gap of norms over the leaves: |‖got‖ - ‖ref‖| over the
    larger of the leaf's reference norm and the median leaf's. With
    ``ref_grad``, leaves whose reference gradient norm is under a
    thousandth of the median leaf's are left out."""
    import torch

    def norms(d):
        return {k: float(torch.linalg.vector_norm(v.double().cpu()))
                for k, v in d.items()}

    g, r = norms(got), norms(ref)
    keys = list(r)
    g = {k: g.get(k, 0.0) for k in keys}   # a leaf Adam never got: unmoved
    if ref_grad is not None:
        gn = norms(ref_grad)
        if not all(map(math.isfinite, gn.values())):
            return math.inf
        med = float(np.median(list(gn.values())))
        keys = [k for k in keys if gn[k] >= 1e-3 * med]
    if not all(math.isfinite(g[k]) and math.isfinite(r[k]) for k in keys):
        return math.inf
    med = float(np.median([r[k] for k in keys]))
    return max(abs(g[k] - r[k]) / max(r[k], med) for k in keys)
