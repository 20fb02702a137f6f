"""One MAPPO training repeat in plain PyTorch: the rollout, the returns,
the actor's and the critic's epochs of Adam steps.

The networks are those of the reference MARL-nav (``models.py``):

  actor : x (F) -> h = W1 x + b1 (no activation) -> mu = tanh(Wmu h + bmu),
          var = softplus(Wvar h + bvar), each 2 wide
  critic: the A agents' observations side by side (A F) -> relu(W1 x + b1)
          -> W2 h + b2

The policy is a diagonal Gaussian with ``var`` its covariance diagonal.
The actor minimizes -(mean(min(r adv, clip(r, 1 - eps, 1 + eps) adv)) +
ent mean(entropy)), r the probability ratio against the rollout's
log-probs; the critic mean(max((v - R)^2, (clip(v, v_old - eps, v_old +
eps) - R)^2)).  ``faithful`` keeps the reference's two quirks: the
advantages of a minibatch are paired with the per-agent rows by a tile
(``Tensor.repeat``) and a minibatch that reaches the buffer's end drops
its last step.  Clips are min(max(x, lo), hi).

Losses and gradients are taken in float64 by autograd (``train_repeat``'s
``dtype``: float32 for a look at what float32 arithmetic alone does); Adam
(betas 0.9, 0.999, eps 1e-8, bias-corrected) steps the float32 weights
with the float32 gradients.  The rollout and the values stay float32, as
the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.nn import functional as F

from benchmark.reference import returns as ret
from benchmark.reference.env_step import EnvStep, roll

ACTOR_KEYS = ("fc1.weight", "fc1.bias", "fc_mu.weight", "fc_mu.bias",
              "fc_var.weight", "fc_var.bias")
CRITIC_KEYS = ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")
_LOG_2PI = math.log(2.0 * math.pi)
_BETA1, _BETA2, _EPS = 0.9, 0.999, 1e-8


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def critic_forward(w: Dict[str, torch.Tensor], x: torch.Tensor):
    h = torch.relu(F.linear(x, w["fc1.weight"], w["fc1.bias"]))
    return F.linear(h, w["fc2.weight"], w["fc2.bias"])


def actor_forward(w: Dict[str, torch.Tensor], x: torch.Tensor):
    h = F.linear(x, w["fc1.weight"], w["fc1.bias"])
    mu = torch.tanh(F.linear(h, w["fc_mu.weight"], w["fc_mu.bias"]))
    var = F.softplus(F.linear(h, w["fc_var.weight"], w["fc_var.bias"]))
    return mu, var


def _side(plain, clipped, is_clipped, larger_clipped):
    """Each row's side of a clip: 0 inside it, 1 clipped with the clipped
    term taken (no gradient through it), 2 clipped with the plain term
    taken."""
    return torch.where(is_clipped, torch.where(larger_clipped, 1, 2),
                       0).to(torch.int8)


def actor_loss(w, obs, actions, old_log_probs, adv, eps: float, ent: float,
               sides=None):
    """The clipped surrogate loss; ``sides``, where given, gets each row's
    side of the ratio clip (``_side``)."""
    mu, var = actor_forward(w, obs)
    diff = actions - mu
    logdet = torch.sum(torch.log(var), -1)
    log_probs = -0.5 * (2 * _LOG_2PI + logdet
                        + torch.sum(diff * diff / var, -1))
    entropy = (1.0 + _LOG_2PI) + 0.5 * logdet
    ratios = torch.exp(log_probs - old_log_probs)
    lo, hi = ratios.new_full((), 1.0 - eps), ratios.new_full((), 1.0 + eps)
    clipped = _clip(ratios, lo, hi)
    if sides is not None:
        sides.append(_side(ratios * adv, clipped * adv, clipped != ratios,
                           clipped * adv < ratios * adv))
    obj = torch.mean(torch.minimum(ratios * adv, clipped * adv))
    return -(obj + ent * torch.mean(entropy))


def critic_loss(w, x, old_values, returns, eps: float, sides=None):
    """The clipped value loss; ``sides``, where given, gets each row's side
    of the value clip (``_side``)."""
    v = critic_forward(w, x)[:, 0]
    clamped = _clip(v, old_values - eps, old_values + eps)
    plain, clipped = (v - returns) ** 2, (clamped - returns) ** 2
    if sides is not None:
        sides.append(_side(plain, clipped, clamped != v, clipped > plain))
    return torch.mean(torch.maximum(plain, clipped))


class Adam:
    """Adam over float32 weights, from a state ``{name: (exp_avg,
    exp_avg_sq, step)}``."""

    def __init__(self, weights: Dict[str, torch.Tensor], state, lr: float):
        self.w = {k: v.clone() for k, v in weights.items()}
        self.m = {k: state[k][0].clone() for k in weights}
        self.v = {k: state[k][1].clone() for k in weights}
        self.t = {k: float(state[k][2]) for k in weights}
        self.lr = lr

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        for k, g in grads.items():
            self.t[k] += 1.0
            t = self.t[k]
            self.m[k] = _BETA1 * self.m[k] + (1.0 - _BETA1) * g
            self.v[k] = _BETA2 * self.v[k] + (1.0 - _BETA2) * g * g
            step_size = self.lr / (1.0 - _BETA1 ** t)
            denom = (torch.sqrt(self.v[k]) / math.sqrt(1.0 - _BETA2 ** t)
                     + _EPS)
            self.w[k] = self.w[k] - step_size * self.m[k] / denom


def minibatch_slices(buffer_len: int, batch_size: int, faithful: bool):
    """(start, size) of each minibatch: full batches, and in faithful mode
    a batch that reaches the buffer's end drops its last step."""
    out = []
    for j in range(buffer_len // batch_size):
        start = j * batch_size
        size = batch_size
        if faithful and start + batch_size >= buffer_len:
            size = buffer_len - 1 - start
        out.append((start, size))
    return out


def bootstrap_observations(step: EnvStep, rows, normalizer: dict):
    """(P, A, F) normalized observations of the state ``rows`` by the
    env's own geometry (arccos, division by the norm), which the GAE
    bootstrap value reads."""
    a, o = step.a, step.o
    pos = torch.stack([rows["px"], rows["py"]], -1).permute(1, 0, 2)
    head = torch.stack([rows["dx"], rows["dy"]], -1).permute(1, 0, 2)
    obst = torch.stack([rows["obx"], rows["oby"]], -1).permute(1, 0, 2)
    target = rows["tg"].T[:, None, :]
    others = torch.tensor([[i for i in range(a) if i != j] for j in range(a)],
                          device=pos.device)

    def angles_and_distances(points):
        if points.dim() == 3:
            points = points[:, None, :, :]
        diff = points - pos[:, :, None, :]
        dist = torch.sqrt(torch.sum(diff * diff, -1))
        unit = diff / torch.clamp_min(dist, 1e-12)[..., None]
        dot = torch.clamp(torch.sum(head[:, :, None, :] * unit, -1),
                          -1.0 + 1e-8, 1.0 - 1e-8)
        orth_x = unit[..., 0] - dot * head[:, :, None, 0]
        ang = torch.where(orth_x > 0.0, -1.0, 1.0) * torch.arccos(dot)
        return torch.where(dist < step.p["cap_distance"], 0.0, ang), dist

    parts = []
    for points in (target, obst, pos[:, others, :]):
        ang, dist = angles_and_distances(points)
        parts += [ang, dist]
    feats = torch.cat([parts[0], parts[1], parts[2], parts[3], parts[4],
                       parts[5]], 2)
    max_dist = math.hypot(normalizer["max_x_value"], normalizer["max_y_value"])
    lo = torch.tensor([-math.pi, 0.0] + o * [-math.pi] + o * [0.0]
                      + (a - 1) * [-math.pi] + (a - 1) * [0.0],
                      device=pos.device)
    hi = torch.tensor([math.pi, max_dist] + o * [math.pi] + o * [max_dist]
                      + (a - 1) * [math.pi] + (a - 1) * [max_dist],
                      device=pos.device)
    return (feats - 0.5 * (lo + hi)) / (0.5 * (hi - lo))


def collect(step: EnvStep, rows, actor, uniforms):
    """The rollout of T = ``uniforms.shape[0]`` steps with sampled actions:
    ``(final rows, buffer dict, episode counts (3,) int64 [truncations,
    collisions, all in target])``."""
    t_len, p = uniforms.shape[0], rows["px"].shape[1]
    a, f = step.a, step.obs_size
    dev = rows["px"].device
    buf = {"obs": torch.empty((t_len, p, a, f), device=dev),
           "actions": torch.empty((t_len, p, a, 2), device=dev),
           "log_probs": torch.empty((t_len, p * a), device=dev),
           "rewards": torch.empty((t_len, p), device=dev),
           "done": torch.empty((t_len, p), dtype=torch.bool, device=dev)}
    counts = torch.zeros(3, dtype=torch.int64, device=dev)

    def on_step(t, rec):
        buf["obs"][t] = rec["obs"]
        buf["actions"][t] = rec["actions"]
        buf["log_probs"][t] = rec["log_probs"]
        buf["rewards"][t] = rec["reward"]
        buf["done"][t] = rec["finished"] > 0.5
        counts.add_(torch.stack([rec["trunc"].sum(), rec["any_coll"].sum(),
                                 rec["all_in_target"].sum()]).to(torch.int64))

    final = roll(step, rows, actor, uniforms, False, on_step)
    return final, buf, counts


def train_repeat(model: dict, normalizer: dict, step: EnvStep, rows,
                 actor, critic, adam_state, uniforms,
                 dtype=torch.float64, sides=None) -> dict:
    """One repeat from the state (``rows``, ``actor``, ``critic`` weights,
    ``adam_state`` = {"actor": {name: (m, v, step)}, "critic": ...}) on
    the kernel's ``uniforms``.  Returns the final rows, the counts, the
    mean return, the per-step losses of each phase and the weights and
    Adam states after the repeat.  Losses and gradients are taken in
    ``dtype``; ``sides``, where given (``{"actor": [], "critic": []}``),
    gets each step's rows' sides of its phase's clip."""
    final, buf, counts = collect(step, rows, actor, uniforms)
    t_len, p, a, f = buf["obs"].shape
    values = critic_forward(critic, buf["obs"].reshape(t_len * p, a * f)
                            ).reshape(t_len, p)
    if model["use_gae"]:
        mean_rew = torch.mean(ret.discounted_returns(
            buf["rewards"], buf["done"], model["gamma"]))
        last = critic_forward(critic, bootstrap_observations(
            step, final, normalizer).reshape(p, a * f))[:, 0]
        returns = ret.gae_advantages(buf["rewards"], buf["done"], values,
                                     last, model["gamma"],
                                     model["gae_lambda"]) + values
    else:
        returns, mean_rew = ret.normalized_returns(
            buf["rewards"], buf["done"], model["gamma"],
            model["returns_f64"])
    slices = minibatch_slices(model["buffer_len"], model["batch_size"],
                              model["faithful"])
    eps = model["epsilon"]

    def actor_batch(start, size):
        d = (returns[start:start + size] - values[start:start + size])
        d = d.reshape(-1)
        adv = d.repeat(a) if model["faithful"] else torch.repeat_interleave(
            d, a)
        sl = slice(start, start + size)
        return (buf["obs"][sl].reshape(-1, f).to(dtype),
                buf["actions"][sl].reshape(-1, 2).to(dtype),
                buf["log_probs"][sl].reshape(-1).to(dtype), adv.to(dtype))

    def critic_batch(start, size):
        sl = slice(start, start + size)
        return (buf["obs"][sl].reshape(-1, a * f).to(dtype),
                values[sl].reshape(-1).to(dtype),
                returns[sl].reshape(-1).to(dtype))

    def phase(weights, state, batches, loss_fn, keys):
        opt = Adam(weights, state, model["lr"])
        losses, first_grad = [], None
        for _ in range(model["num_epochs"]):
            for batch in batches:
                with torch.enable_grad():
                    wd = {k: opt.w[k].to(dtype).detach().requires_grad_()
                          for k in keys}
                    loss = loss_fn(wd, *batch)
                    grads = torch.autograd.grad(loss, [wd[k] for k in keys])
                if first_grad is None:
                    first_grad = {k: torch.linalg.vector_norm(g)
                                  for k, g in zip(keys, grads)}
                opt.step({k: g.to(torch.float32)
                          for k, g in zip(keys, grads)})
                losses.append(loss.detach())
        return opt, torch.stack(losses), first_grad

    actor_opt, actor_losses, actor_grad = phase(
        actor, adam_state["actor"], [actor_batch(*s) for s in slices],
        lambda w, *b: actor_loss(w, *b, eps, model["ent_const"],
                                 sides and sides["actor"]), ACTOR_KEYS)
    critic_opt, critic_losses, critic_grad = phase(
        critic, adam_state["critic"], [critic_batch(*s) for s in slices],
        lambda w, *b: critic_loss(w, *b, eps, sides and sides["critic"]),
        CRITIC_KEYS)
    return {"rows": final, "counts": counts, "mean_rew": mean_rew,
            "actor_losses": actor_losses, "critic_losses": critic_losses,
            "actor": actor_opt.w, "critic": critic_opt.w,
            "adam": {net: {k: (opt.m[k], opt.v[k], opt.t[k]) for k in opt.w}
                     for net, opt in (("actor", actor_opt),
                                      ("critic", critic_opt))},
            "first_grad_norms": {"actor": actor_grad, "critic": critic_grad}}
