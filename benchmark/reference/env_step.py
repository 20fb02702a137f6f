"""The env step of the collect and rollout kernels, in plain PyTorch.

A frozen copy of the port's plain step (the triangle scenario: 3 agents,
O obstacles), kept here so that the benchmark's check does not take the
program's own arithmetic on trust.  Every operation is a float32
elementwise PyTorch operation in the kernels' order, so on the card it
gives the kernels' bits: the acos polynomial (Abramowitz & Stegun 4.4.45),
bounded sin / cos polynomials, the heading reward as a dot-product
threshold, the actor as its (4, F) affine operator (the actor has no
hidden activation), Box-Muller normals from the Philox uniforms, the
clamped integrator, the rewards and the auto-reset blend.

The state is the kernels' row layout: a dict of (rows, P) float32 tensors
``px py dx dy sp`` (A rows), ``obx oby`` (O rows), ``tg`` (target x; y)
and ``misc`` (step counter; target-reach latch), in ``ROW_FIELDS`` order.

``roll`` runs T steps; on the card one step is captured as a CUDA graph
and replayed, which keeps the ~1,700 small operations of a step cheap to
launch and changes none of them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

ROW_FIELDS = ("px", "py", "dx", "dy", "sp", "obx", "oby", "tg", "misc")

_NORMALIZE_EPS = 1e-12
_ACOS_CLAMP = 1e-8
_TWO_PI = 2.0 * math.pi
_LOG_2PI = math.log(2.0 * math.pi)
_ACOS_C = (-0.0012624911, 0.0066700901, -0.0170881256, 0.0308918810,
           -0.0501743046, 0.0889789874, -0.2145988016, 1.5707963050)
_SIN_C = (0.99999999442030307, -0.16666664568359335,
          0.0083333102899997395, -0.00019840151841299232,
          2.752939488670167e-06, -2.4676487851666484e-08,
          1.3449973826791738e-10)
_COS_C = (0.99999998904852216, -0.49999989101180597,
          0.041666489213904624, -0.0013887803571303186,
          2.4769882914249208e-05, -2.7079024321864158e-07,
          1.7245068538391953e-09)


def acos(x):
    ax = torch.abs(x)
    poly = _ACOS_C[0] * ax + _ACOS_C[1]
    for c in _ACOS_C[2:]:
        poly = poly * ax + c
    r = torch.sqrt(torch.clamp_min(1.0 - ax, 0.0)) * poly
    return torch.where(x < 0.0, math.pi - r, r)


def sin_pi(x):
    x2 = x * x
    acc = _SIN_C[-1] * x2 + _SIN_C[-2]
    for c in _SIN_C[-3::-1]:
        acc = acc * x2 + c
    return acc * x


def cos_pi(x):
    x2 = x * x
    acc = _COS_C[-1] * x2 + _COS_C[-2]
    for c in _COS_C[-3::-1]:
        acc = acc * x2 + c
    return acc


def box_muller(u1, u2):
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-12)))
    t = _TWO_PI * u2 - math.pi
    rn = -r
    return rn * cos_pi(t), rn * sin_pi(t)


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


class EnvStep:
    """One step of every env, from a configuration's ``env``, ``init``,
    ``normalizer`` and ``scaler`` sections (dicts of the published
    values)."""

    def __init__(self, env: dict, init: dict, normalizer: dict,
                 scaler: dict):
        self.p = p = dict(env)
        self.a, self.o = p["num_agents"], p["num_obstacles"]
        if self.a != 3:
            raise ValueError("the triangle scenario has 3 agents")
        self.obs_size = 2 + 2 * self.o + 2 * (self.a - 1)
        self.noisy = bool(init["noisy_ags"])
        self.n_draws = 2 * self.a + 2 * self.o + (3 * self.a if self.noisy
                                                  else 0)
        self.pos_std = init["ags_dist"] * math.sqrt(init["ags_std"])
        self.angle_range = init["angle_range"]
        self.init_speed = init["init_speed"]
        half, r3 = 0.5 * init["ags_dist"], math.sqrt(3.0)
        self.base_x = tuple(init["ags_cent_x"] + half * v
                            for v in (-1.0 / r3, 2.0 / r3, -1.0 / r3))
        self.base_y = tuple(init["ags_cent_y"] + half * v
                            for v in (1.0, 0.0, -1.0))
        self.ox_range = init["obst_max_x"] - init["obst_min_x"]
        self.oy_range = init["obst_max_y"] - init["obst_min_y"]
        self.ox_mean = 0.5 * (init["obst_min_x"] + init["obst_max_x"])
        self.oy_mean = 0.5 * (init["obst_min_y"] + init["obst_max_y"])
        max_dist = math.hypot(normalizer["max_x_value"],
                              normalizer["max_y_value"])
        self.inv_pi = 1.0 / math.pi
        self.d_scale = 2.0 / max_dist
        amin, amax = -math.pi, math.pi
        cmin, cmax = scaler["min_accel"], scaler["max_accel"]
        self.ang_mean = 0.5 * (amin + amax)
        self.ang_scale = 0.5 * (amax - amin)
        self.acc_mean = 0.5 * (cmin + cmax)
        self.acc_scale = 0.5 * (cmax - cmin)
        self.cos_head = math.cos(p["max_angle_diff"])
        # A division by a constant is a product with its reciprocal, as in
        # the kernels.
        self.inv_init_dist = 1.0 / p["init_dist"]
        self.inv_max_at_prop_d = 1.0 / p["max_at_prop_d"]
        self.inv_bond_sharpness = 1.0 / p["bond_sharpness"]
        self.inv_others = 1.0 / (self.a - 1)
        self.inv_agents = 1.0 / self.a

    # ------------------------------------------------------------------
    def geom(self, px_a, py_a, hx_a, hy_a, tx, ty):
        ddx = tx - px_a
        ddy = ty - py_a
        dist = torch.sqrt(ddx * ddx + ddy * ddy)
        inv = 1.0 / torch.clamp_min(dist, _NORMALIZE_EPS)
        ux = ddx * inv
        uy = ddy * inv
        dot = torch.clamp(hx_a * ux + hy_a * uy, -1.0 + _ACOS_CLAMP,
                          1.0 - _ACOS_CLAMP)
        orth_x = ux - dot * hx_a
        sign = torch.where(orth_x > 0.0, -1.0, 1.0)
        ang = sign * acos(dot)
        ang = torch.where(dist < self.p["cap_distance"], 0.0, ang)
        return ang, dist

    def obs_feats(self, px, py, hx, hy, obx, oby, tx, ty):
        """[agent][feature] normalized observation rows."""
        out = []
        for i in range(self.a):
            t_ang, t_dist = self.geom(px[i], py[i], hx[i], hy[i], tx, ty)
            feats = [t_ang * self.inv_pi, t_dist * self.d_scale - 1.0]
            o_ang, o_dist = [], []
            for j in range(self.o):
                oa, od = self.geom(px[i], py[i], hx[i], hy[i], obx[j], oby[j])
                o_ang.append(oa * self.inv_pi)
                o_dist.append(od * self.d_scale - 1.0)
            n_ang, n_dist = [], []
            for j in range(self.a):
                if j == i:
                    continue
                na, nd = self.geom(px[i], py[i], hx[i], hy[i], px[j], py[j])
                n_ang.append(na * self.inv_pi)
                n_dist.append(nd * self.d_scale - 1.0)
            out.append(feats + o_ang + o_dist + n_ang + n_dist)
        return out

    def actor_affine(self, feats, wa, ca, want_var, rounding):
        """tanh / softplus heads of z = wa x + ca (``wa`` (4, F), ``ca``
        (4,) as Python floats); ``rounding`` rounds each operand of the
        products (the control's lower precision) or is None."""
        if rounding is not None:
            feats = [rounding(f) for f in feats]
        z = []
        for k in range(4 if want_var else 2):
            acc = wa[k][0] * feats[0]
            for f in range(1, self.obs_size):
                acc = acc + wa[k][f] * feats[f]
            z.append(acc + ca[k])
        mu = [torch.tanh(z[0]), torch.tanh(z[1])]
        return mu, ([softplus(z[2]), softplus(z[3])] if want_var else None)

    def dynamics(self, px, py, hx, hy, sp, ang_raw, acc_raw):
        p = self.p
        npx, npy, nhx, nhy, nsp = [], [], [], [], []
        for i in range(self.a):
            ang = torch.clamp(self.ang_mean + self.ang_scale * ang_raw[i],
                              -math.pi, math.pi)
            acc = torch.clamp(self.acc_mean + self.acc_scale * acc_raw[i],
                              p["min_accel"], p["max_accel"])
            c, s = cos_pi(ang), sin_pi(ang)
            nhx.append(c * hx[i] - s * hy[i])
            nhy.append(s * hx[i] + c * hy[i])
            nsp.append(torch.clamp(sp[i] + acc, p["min_speed"],
                                   p["max_speed"]))
            npx.append(px[i] + nhx[i] * nsp[i])
            npy.append(py[i] + nhy[i] * nsp[i])
        return npx, npy, nhx, nhy, nsp

    def rewards(self, npx, npy, nhx, nhy, obx, oby, tx, ty, px, py):
        p = self.p
        zeros = torch.zeros_like(tx)
        reward_sum = zeros
        all_in_target = torch.ones_like(tx)
        any_coll = zeros
        max_t_dist = zeros
        prev_max_t_dist = zeros
        for i in range(self.a):
            ddx, ddy = tx - npx[i], ty - npy[i]
            t_dist = torch.sqrt(ddx * ddx + ddy * ddy)
            max_t_dist = torch.maximum(max_t_dist, t_dist)
            if p["group_soft_factor"]:
                pdx, pdy = tx - px[i], ty - py[i]
                prev_max_t_dist = torch.maximum(
                    prev_max_t_dist, torch.sqrt(pdx * pdx + pdy * pdy))
            inv = 1.0 / torch.clamp_min(t_dist, _NORMALIZE_EPS)
            t_dot = torch.clamp((nhx[i] * ddx + nhy[i] * ddy) * inv,
                                -1.0 + _ACOS_CLAMP, 1.0 - _ACOS_CLAMP)
            o_risk, o_coll = zeros, zeros
            for j in range(self.o):
                odx, ody = obx[j] - npx[i], oby[j] - npy[i]
                o_dist = torch.sqrt(odx * odx + ody * ody)
                o_risk = torch.maximum(o_risk,
                                       (o_dist < p["ob_risk_dist"]).float())
                o_coll = torch.maximum(o_coll,
                                       (o_dist < p["ob_coll_dist"]).float())
            n_risk, n_coll, band_sum, bond_sum = zeros, zeros, zeros, zeros
            for j in range(self.a):
                if j == i:
                    continue
                ndx, ndy = npx[j] - npx[i], npy[j] - npy[i]
                n_dist = torch.sqrt(ndx * ndx + ndy * ndy)
                n_risk = torch.maximum(n_risk,
                                       (n_dist < p["ag_risk_dist"]).float())
                n_coll = torch.maximum(n_coll,
                                       (n_dist < p["ag_coll_dist"]).float())
                band_sum = band_sum + ((p["agents_min_d"] < n_dist)
                                       & (n_dist < p["agents_max_d"])).float()
                scaled = (n_dist - p["ideal_dist"]) * self.inv_bond_sharpness
                bond_sum = bond_sum + 1.0 / (1.0 + scaled * scaled)
            in_target = (t_dist < p["target_radius"]).float()
            heading = torch.where(t_dist < p["cap_distance"], 1.0,
                                  (t_dot > self.cos_head).float())
            soft = -t_dist * self.inv_init_dist
            dist_sc = (torch.clamp_max(band_sum, p["max_at_prop_d"])
                       * self.inv_max_at_prop_d)
            bond = bond_sum * self.inv_others
            risk = torch.clamp_max(o_risk + n_risk, 1.0)
            coll = torch.clamp_max(o_coll + n_coll, 1.0)
            all_in_target = torch.minimum(all_in_target, in_target)
            any_coll = torch.maximum(any_coll, coll)
            reward_sum = reward_sum + (
                p["heading_factor"] * heading
                + p["distance_factor"] * dist_sc
                + p["soft_factor"] * soft
                + p["bond_factor"] * bond
                - p["risk_factor"] * risk)
        reward = (reward_sum * self.inv_agents
                  + p["target_factor"] * all_in_target)
        if p["group_soft_factor"]:
            reward = reward + (p["group_soft_factor"] / p["init_dist"]) * (
                prev_max_t_dist - max_t_dist)
        return reward, all_in_target, any_coll

    def reset_blend(self, m, km, npx, npy, nhx, nhy, nsp, obx, oby,
                    step_num, new_latch, u):
        o = self.o
        new_obx = [m * ((u[j] - 0.5) * self.ox_range + self.ox_mean)
                   + km * obx[j] for j in range(o)]
        new_oby = [m * ((u[o + j] - 0.5) * self.oy_range + self.oy_mean)
                   + km * oby[j] for j in range(o)]
        k = 2 * o
        px, py, dx, dy, sp = [], [], [], [], []
        for i in range(self.a):
            if self.noisy:
                z0, z1 = box_muller(u[k + 3 * i], u[k + 3 * i + 1])
                ang = self.angle_range * (u[k + 3 * i + 2] - 0.5)
                bx = self.base_x[i] + self.pos_std * z0
                by = self.base_y[i] + self.pos_std * z1
                if self.angle_range <= _TWO_PI:
                    hx0, hy0 = cos_pi(ang), sin_pi(ang)
                else:
                    hx0, hy0 = torch.cos(ang), torch.sin(ang)
                dy.append(m * hy0 + km * nhy[i])
            else:
                bx, by, hx0 = self.base_x[i], self.base_y[i], 1.0
                dy.append(km * nhy[i])
            px.append(m * bx + km * npx[i])
            py.append(m * by + km * npy[i])
            dx.append(m * hx0 + km * nhx[i])
            sp.append(m * self.init_speed + km * nsp[i])
        return px, py, dx, dy, sp, new_obx, new_oby, km * step_num, new_latch

    # ------------------------------------------------------------------
    def __call__(self, rows: Dict[str, torch.Tensor], u: torch.Tensor, wa,
                 ca, deterministic: bool, rounding=None):
        """One step from ``rows`` on the uniforms ``u`` (n_draws, P).
        Returns ``(next rows, record)``; the record holds the pre-step
        observations (P, A, F), the raw actions (P, A, 2), the log-probs
        (P * A; absent with policy-mean actions), the reward, the finished
        flag, and the truncation, collision and all-in-target flags."""
        a = self.a
        px, py, hx, hy, sp = (list(rows[k].unbind(0))
                              for k in ("px", "py", "dx", "dy", "sp"))
        obx, oby = list(rows["obx"].unbind(0)), list(rows["oby"].unbind(0))
        tx, ty = rows["tg"][0], rows["tg"][1]
        step_num, latch = rows["misc"][0], rows["misc"][1]
        feats_all = self.obs_feats(px, py, hx, hy, obx, oby, tx, ty)
        ang_raw, acc_raw, lp = [], [], []
        for i in range(a):
            mu, var = self.actor_affine(feats_all[i], wa, ca,
                                        not deterministic, rounding)
            if deterministic:
                ang_raw.append(mu[0])
                acc_raw.append(mu[1])
                continue
            z0, z1 = box_muller(u[2 * i], u[2 * i + 1])
            ang_raw.append(mu[0] + torch.sqrt(var[0]) * z0)
            acc_raw.append(mu[1] + torch.sqrt(var[1]) * z1)
            lp.append(-0.5 * (2.0 * _LOG_2PI + torch.log(var[0])
                              + torch.log(var[1]) + z0 * z0 + z1 * z1))
        npx, npy, nhx, nhy, nsp = self.dynamics(px, py, hx, hy, sp, ang_raw,
                                                acc_raw)
        step_num = step_num + 1.0
        trunc = (step_num > float(self.p["episode_len"] - 1)).float()
        reward, all_in_target, any_coll = self.rewards(
            npx, npy, nhx, nhy, obx, oby, tx, ty, px, py)
        terminated = torch.maximum(any_coll, latch)
        finished = torch.maximum(terminated, trunc)
        new_latch = torch.where(latch > 0.5, 0.0, all_in_target)
        record = {
            "obs": torch.stack([torch.stack(f, -1) for f in feats_all], 1),
            "actions": torch.stack([torch.stack([g, c], -1) for g, c
                                    in zip(ang_raw, acc_raw)], 1),
            "reward": reward, "finished": finished, "trunc": trunc,
            "any_coll": any_coll, "all_in_target": all_in_target}
        if not deterministic:
            record["log_probs"] = torch.stack(lp, 1).reshape(-1)
        (px, py, hx, hy, sp, obx, oby, step_num, latch) = self.reset_blend(
            finished, 1.0 - finished, npx, npy, nhx, nhy, nsp, obx, oby,
            step_num, new_latch, u[2 * a:])
        nxt = {"px": torch.stack(px), "py": torch.stack(py),
               "dx": torch.stack(hx), "dy": torch.stack(hy),
               "sp": torch.stack(sp), "obx": torch.stack(obx),
               "oby": torch.stack(oby), "tg": rows["tg"].clone(),
               "misc": torch.stack([step_num, latch])}
        return nxt, record


def affine_operator(actor: Dict[str, torch.Tensor]):
    """The actor's (4, F) operator and (4,) offset, z = a x + c, in
    float32 (TF32 off): the actor has no hidden activation."""
    w1, b1 = actor["fc1.weight"], actor["fc1.bias"]
    heads = (("fc_mu.weight", "fc_mu.bias"), ("fc_var.weight", "fc_var.bias"))
    a = torch.cat([actor[w] @ w1 for w, _ in heads])
    c = torch.cat([actor[w] @ b1 + actor[b] for w, b in heads])
    return a, c


def roll(step: EnvStep, rows: Dict[str, torch.Tensor],
         actor: Dict[str, torch.Tensor], uniforms: torch.Tensor,
         deterministic: bool, on_step: Callable[[int, dict], None],
         rounding: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """``uniforms.shape[0]`` steps from ``rows`` with the actor ``actor``
    (weights by ``named_parameters`` name); ``on_step(t, record)`` sees
    each step's record (valid until the next step).  Returns the final
    rows.  ``rounding`` rounds the actor's operands (the control)."""
    a_comp, c_comp = affine_operator(actor)
    if rounding is not None:
        a_comp, c_comp = rounding(a_comp), rounding(c_comp)
    wa, ca = a_comp.tolist(), c_comp.tolist()
    state = {k: rows[k].clone() for k in ROW_FIELDS}
    u_static = uniforms[0].clone()

    def body():
        nxt, rec = step(state, u_static, wa, ca, deterministic, rounding)
        for k in ROW_FIELDS:
            state[k].copy_(nxt[k])
        return rec

    if u_static.device.type != "cuda":
        for t in range(uniforms.shape[0]):
            u_static.copy_(uniforms[t])
            on_step(t, body())
        return state
    # One step as a CUDA graph, replayed T times.  The warm-up step runs
    # on a side stream and is undone, as capture requires.
    saved = {k: v.clone() for k, v in state.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    for k in ROW_FIELDS:
        state[k].copy_(saved[k])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rec = body()
    for t in range(uniforms.shape[0]):
        u_static.copy_(uniforms[t])
        graph.replay()
        on_step(t, rec)
    return state
