"""Per-env step physics of the fused collect kernel, as plain PyTorch.

Port of ``marlnav_tpu/ops/step_math.py``.  Every function works on the row
layout: one (P,) tensor per agent, obstacle or coordinate.  These are the
building blocks of ``ops.fused_collect.collect_rows_reference``, the plain
version that the CUDA kernel (ops/csrc/step_math.cuh) is held against; the
kernel performs the same float32 operations in the same order, so keep the
two in step when either changes.

The math replicates ``marlnav_tpu.env`` op for op, with the kernel's
choices: the Hastings ``acos`` polynomial, bounded-range ``sin_pi`` /
``cos_pi`` polynomials, the heading reward as a dot-product threshold
(``acos`` is monotone, so ``|angle| < max_angle_diff`` iff
``dot > cos(max_angle_diff)``), and the actor as its precomposed (4, obs)
affine operator.
"""

from __future__ import annotations

import math

import torch

from marlnav_tpu_torch.env.initializers import triangle_base_positions

_NORMALIZE_EPS = 1e-12
_ACOS_CLAMP = 1e-8
_TWO_PI = 2.0 * math.pi

# Hastings polynomial (Abramowitz & Stegun 4.4.45), |err| <= 2e-8.
_ACOS_C = (-0.0012624911, 0.0066700901, -0.0170881256, 0.0308918810,
           -0.0501743046, 0.0889789874, -0.2145988016, 1.5707963050)
# Least-squares odd/even polynomials on [-pi, pi]: |err| <= 6.1e-7 in f32.
_SIN_C = (0.99999999442030307, -0.16666664568359335,
          0.0083333102899997395, -0.00019840151841299232,
          2.752939488670167e-06, -2.4676487851666484e-08,
          1.3449973826791738e-10)
_COS_C = (0.99999998904852216, -0.49999989101180597,
          0.041666489213904624, -0.0013887803571303186,
          2.4769882914249208e-05, -2.7079024321864158e-07,
          1.7245068538391953e-09)


def acos(x: torch.Tensor) -> torch.Tensor:
    """arccos on [-1, 1] by the Hastings polynomial."""
    ax = torch.abs(x)
    poly = _ACOS_C[0] * ax + _ACOS_C[1]
    for c in _ACOS_C[2:]:
        poly = poly * ax + c
    r = torch.sqrt(torch.clamp_min(1.0 - ax, 0.0)) * poly
    return torch.where(x < 0.0, math.pi - r, r)


def sin_pi(x: torch.Tensor) -> torch.Tensor:
    """sin(x) for |x| <= pi (plus a few f32 ulp of slack at the ends)."""
    x2 = x * x
    acc = _SIN_C[-1] * x2 + _SIN_C[-2]
    for c in _SIN_C[-3::-1]:
        acc = acc * x2 + c
    return acc * x


def cos_pi(x: torch.Tensor) -> torch.Tensor:
    """cos(x) for |x| <= pi (plus a few f32 ulp of slack at the ends)."""
    x2 = x * x
    acc = _COS_C[-1] * x2 + _COS_C[-2]
    for c in _COS_C[-3::-1]:
        acc = acc * x2 + c
    return acc


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) from raw 32-bit random words (int32): the top 24 bits
    (arithmetic shift), so every value is exact in float32 and < 1."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0) + 0.5


def box_muller(u1: torch.Tensor, u2: torch.Tensor):
    """(z0, z1) standard-normal pair from two uniforms.  theta = 2*pi*u2 is
    shifted to t = theta - pi in [-pi, pi) so the bounded polynomials
    apply: cos(theta) = -cos_pi(t), sin(theta) = -sin_pi(t)."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-12)))
    t = _TWO_PI * u2 - math.pi
    rn = -r
    return rn * cos_pi(t), rn * sin_pi(t)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` evaluates it:
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


class StepMath:
    """Step physics over the static configs, on row-layout tensors."""

    def __init__(self, env_params, init_cfg, normalizer_cfg, scaler_cfg):
        p = env_params
        self.p = p
        self.a, self.o = p.num_agents, p.num_obstacles
        if self.a != 3:
            raise NotImplementedError(
                "the fused collect covers the triangle scenario family "
                "(3 agents)")
        self.init_cfg = init_cfg
        self.obs_size = p.obs_size
        # Draws per env-step: 2 per agent for the action, then 2 per
        # obstacle for the reset draw, plus — with noisy_ags — 3 per agent
        # (a Box-Muller pair for the position noise + 1 heading angle).
        self.noisy = bool(init_cfg.noisy_ags)
        self.n_reset_draws = 2 * self.o + (3 * self.a if self.noisy else 0)
        self.n_draws = 2 * self.a + self.n_reset_draws
        self.pos_std = init_cfg.ags_dist * math.sqrt(init_cfg.ags_std)
        self.angle_range = init_cfg.angle_range
        self.base_x, self.base_y = triangle_base_positions(init_cfg)
        self.ox_range = init_cfg.obst_max_x - init_cfg.obst_min_x
        self.oy_range = init_cfg.obst_max_y - init_cfg.obst_min_y
        self.ox_mean = 0.5 * (init_cfg.obst_min_x + init_cfg.obst_max_x)
        self.oy_mean = 0.5 * (init_cfg.obst_min_y + init_cfg.obst_max_y)

        # Normalizer feature scales (utils/transforms.py).
        max_dist = math.hypot(normalizer_cfg.max_x_value,
                              normalizer_cfg.max_y_value)
        self.inv_pi = 1.0 / math.pi
        self.d_scale = 2.0 / max_dist  # x * d_scale - 1

        # Action scaler: raw [-1,1] -> [angle, accel] physical.
        (amin, cmin), (amax, cmax) = scaler_cfg.bounds()
        self.ang_mean, self.ang_scale = 0.5 * (amin + amax), 0.5 * (amax - amin)
        self.acc_mean, self.acc_scale = 0.5 * (cmin + cmax), 0.5 * (cmax - cmin)
        self.cos_head = math.cos(p.max_angle_diff)
        # Divisions by a constant are multiplications by its reciprocal,
        # here and in the kernel: PyTorch's CUDA division by a Python
        # scalar multiplies by the reciprocal, its CPU division divides, so
        # writing the product keeps the plain version identical on both.
        self.inv_init_dist = 1.0 / p.init_dist
        self.inv_max_at_prop_d = 1.0 / p.max_at_prop_d
        self.inv_bond_sharpness = 1.0 / p.bond_sharpness
        self.inv_others = 1.0 / (self.a - 1)
        self.inv_agents = 1.0 / self.a

    # ------------------------------------------------------------------
    def geom(self, px_a, py_a, hx_a, hy_a, tx, ty):
        """Angle + distance rows (env/geometry.py angles_and_distances)."""
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
        ang = torch.where(dist < self.p.cap_distance, 0.0, ang)
        return ang, dist

    def obs_feats(self, px, py, hx, hy, obx, oby, tx, ty):
        """Normalized observation rows, [agent][feature] in the
        env/types.py Observations concat order."""
        feats_all = []
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
            feats_all.append(feats + o_ang + o_dist + n_ang + n_dist)
        return feats_all

    def actor_affine(self, feats, wa, ca, want_var=True):
        """One agent's actor heads through the precomposed affine operator
        z = wa x + ca (``wa`` (4, obs) and ``ca`` (4,) as nested Python
        floats; ops.fused_collect._affine_compose): the reference actor has
        no hidden activation, so obs -> head pre-activations is affine.
        Returns (mu[2], var[2]); var is None unless ``want_var``."""
        z = []
        for k in range(4 if want_var else 2):
            acc = wa[k][0] * feats[0]
            for f in range(1, self.obs_size):
                acc = acc + wa[k][f] * feats[f]
            z.append(acc + ca[k])
        mu = [torch.tanh(z[0]), torch.tanh(z[1])]
        return mu, ([softplus(z[2]), softplus(z[3])] if want_var else None)

    def dynamics(self, px, py, hx, hy, sp, ang_raw, acc_raw):
        """Action scaling + clamped integrator (env/dynamics.py)."""
        p = self.p
        npx, npy, nhx, nhy, nsp = [], [], [], [], []
        for i in range(self.a):
            ang = torch.clamp(self.ang_mean + self.ang_scale * ang_raw[i],
                              -math.pi, math.pi)
            acc = torch.clamp(self.acc_mean + self.acc_scale * acc_raw[i],
                              p.min_accel, p.max_accel)
            c, s = cos_pi(ang), sin_pi(ang)  # post-clip: |ang| <= pi
            nhx.append(c * hx[i] - s * hy[i])
            nhy.append(s * hx[i] + c * hy[i])
            nsp.append(torch.clamp(sp[i] + acc, p.min_speed, p.max_speed))
            npx.append(px[i] + nhx[i] * nsp[i])
            npy.append(py[i] + nhy[i] * nsp[i])
        return npx, npy, nhx, nhy, nsp

    def rewards(self, npx, npy, nhx, nhy, obx, oby, tx, ty, px, py):
        """(reward, all_in_target, any_coll) rows from the moved,
        pre-reinit state (env/reward.py).  ``px``/``py`` are the PRE-move
        positions, read only when ``group_soft_factor`` is set."""
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
            if p.group_soft_factor:
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
                                       (o_dist < p.ob_risk_dist).float())
                o_coll = torch.maximum(o_coll,
                                       (o_dist < p.ob_coll_dist).float())

            n_risk, n_coll, band_sum, bond_sum = zeros, zeros, zeros, zeros
            for j in range(self.a):
                if j == i:
                    continue
                ndx, ndy = npx[j] - npx[i], npy[j] - npy[i]
                n_dist = torch.sqrt(ndx * ndx + ndy * ndy)
                n_risk = torch.maximum(n_risk,
                                       (n_dist < p.ag_risk_dist).float())
                n_coll = torch.maximum(n_coll,
                                       (n_dist < p.ag_coll_dist).float())
                band_sum = band_sum + ((p.agents_min_d < n_dist)
                                       & (n_dist < p.agents_max_d)).float()
                scaled = (n_dist - p.ideal_dist) * self.inv_bond_sharpness
                bond_sum = bond_sum + 1.0 / (1.0 + scaled * scaled)

            in_target = (t_dist < p.target_radius).float()
            heading = torch.where(t_dist < p.cap_distance, 1.0,
                                  (t_dot > self.cos_head).float())
            soft = -t_dist * self.inv_init_dist
            dist_sc = (torch.clamp_max(band_sum, p.max_at_prop_d)
                       * self.inv_max_at_prop_d)
            bond = bond_sum * self.inv_others
            risk = torch.clamp_max(o_risk + n_risk, 1.0)
            coll = torch.clamp_max(o_coll + n_coll, 1.0)

            all_in_target = torch.minimum(all_in_target, in_target)
            any_coll = torch.maximum(any_coll, coll)
            # Per-agent reward WITHOUT the group target term (it needs the
            # min over agents; added after the loop).
            reward_sum = reward_sum + (
                p.heading_factor * heading
                + p.distance_factor * dist_sc
                + p.soft_factor * soft
                + p.bond_factor * bond
                - p.risk_factor * risk
            )

        # The group target bonus broadcasts to every agent, so its mean
        # contribution is target_factor * all_in_target; likewise the
        # group-convergence shaping (env/reward.py, default off).
        reward = reward_sum * self.inv_agents + p.target_factor * all_in_target
        if p.group_soft_factor:
            reward = reward + (p.group_soft_factor / p.init_dist) * (
                prev_max_t_dist - max_t_dist)
        return reward, all_in_target, any_coll

    def reset_blend(self, m, km, npx, npy, nhx, nhy, nsp, obx, oby,
                    step_num, new_latch, u):
        """Auto-reset: fresh triangle draw from raw uniforms ``u``
        (``n_reset_draws`` rows in [0, 1)), mask-blended with ``m`` (1 where
        the env finished) and ``km = 1 - m`` (env/env.py step reinit;
        noisy_ags per env/initializers.py).  Returns the next state rows
        ``(px, py, dx, dy, sp, obx, oby, step_num, latch)``; the target is
        constant under the triangle init."""
        o = self.o
        new_obx = [m * ((u[j] - 0.5) * self.ox_range + self.ox_mean)
                   + km * obx[j] for j in range(o)]
        new_oby = [m * ((u[o + j] - 0.5) * self.oy_range + self.oy_mean)
                   + km * oby[j] for j in range(o)]
        k = 2 * o
        px, py, dx, dy, sp = [], [], [], [], []
        for i in range(self.a):
            if self.noisy:
                # Gaussian position noise + uniform heading rotation of (1, 0).
                z0, z1 = box_muller(u[k + 3 * i], u[k + 3 * i + 1])
                ang = self.angle_range * (u[k + 3 * i + 2] - 0.5)
                bx = self.base_x[i] + self.pos_std * z0
                by = self.base_y[i] + self.pos_std * z1
                if self.angle_range <= _TWO_PI:
                    hx0, hy0 = cos_pi(ang), sin_pi(ang)  # |ang| <= pi
                else:  # diagnostic configs with wider ranges
                    hx0, hy0 = torch.cos(ang), torch.sin(ang)
                dy.append(m * hy0 + km * nhy[i])
            else:
                bx, by, hx0 = self.base_x[i], self.base_y[i], 1.0
                dy.append(km * nhy[i])
            px.append(m * bx + km * npx[i])
            py.append(m * by + km * npy[i])
            dx.append(m * hx0 + km * nhx[i])
            sp.append(m * self.init_cfg.init_speed + km * nsp[i])
        return px, py, dx, dy, sp, new_obx, new_oby, km * step_num, new_latch
